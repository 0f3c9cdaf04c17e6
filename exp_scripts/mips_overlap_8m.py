"""MIPS routing at scale: does overlap fix the high-norm-attractor regime?

VERDICT r3 weak #5: the 16M/32 MIPS GP run needed 13 probes for recall
0.95 (vs 3-4 for L2) — the T2I problem: high-norm points attract queries
across partition boundaries. The reference's own answer is overlapping
clustering (OGP/centroid overlap, overlapping_partitioning.cpp:143-235).
This measures it at the resident 8M/32 scale on the GPU:

  arm A: subsample-GP MIPS partition, recall curve (baseline)
  arm B: same partition + centroid-ranked overlap (o=0.2): each point may
         join foreign clusters whose representatives score it best under
         MIPS, globally cheapest-first with capacity admission — then the
         same router, same voting, dedup in the fused engine.

Probe costs are NOT directly comparable across arms (overlap inflates the
per-shard scan by ~o); the JSON reports scanned-rows-per-query at the 0.95
target for both, which is the honest cost metric.

Usage: python exp_scripts/mips_overlap_8m.py   (~45-70 min cold)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N, D, NQ, SHARDS, K = 8_000_000, 96, 4096, 32, 10
if os.environ.get("GPANN_SMOKE"):  # tiny CPU smoke test of the driver logic
    N, D, NQ, SHARDS = 40_000, 16, 128, 4
SEED = 555
OVERLAP = 0.2
KEEP = min(5, SHARDS - 1)  # foreign-cluster candidates per point (ref num_keep)
TARGET = 0.95
VOTING_T = 60
RULE = "min_dist"
QB = 128

_T0 = time.time()


def log(msg):
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def probes_at(curve, target):
    ok = np.nonzero(np.asarray(curve) >= target)[0]
    return int(ok[0] + 1) if len(ok) else len(curve)


def main() -> int:
    import jax.numpy as jnp

    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval import kth_neighbor_distance, recall_from_ids
    from gpann_tpu.eval.recall import oracle_recall
    from gpann_tpu.eval.synth import dataset_cached, generate_queries
    from gpann_tpu.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu.search.serve import ServingEngine

    from gpann_tpu import artifact_dir

    cache_dir = artifact_dir()
    pts, _ = dataset_cached("hard", N, D, SEED)
    q = generate_queries("hard", NQ, D, SEED)
    log(f"data ready {pts.shape}")

    cache = os.path.join(cache_dir, f"mipso_{SEED}_{N}_{D}_{NQ}_{SHARDS}.npz")
    art = dict(np.load(cache)) if os.path.exists(cache) else {}

    if "gt_ids" not in art:
        from gpann_tpu.eval.recall import compute_ground_truth

        gt_ids, gt_dists = compute_ground_truth(pts, q, K, metric="mips")
        art["gt_ids"], art["gt_dists"] = gt_ids, gt_dists
        np.savez(cache, **art)
        log("MIPS ground truth computed")
    if "assign" not in art:
        from gpann_tpu.gp.scale import subsample_gp_partition

        t0 = time.time()
        part, (aggs, agg_lbl, _, _) = subsample_gp_partition(
            pts, k=SHARDS, eps=0.05, seed=SEED, metric="mips",
            num_subsample=1_000_000, num_aggregate=4096,
            return_artifacts=True)
        art["assign"] = part
        art["aggs"], art["agg_lbl"] = aggs, agg_lbl
        art["build_time"] = np.float64(time.time() - t0)
        np.savez(cache, **art)
        log(f"MIPS GP partition in {float(art['build_time']):.0f}s")
    if "routing_points" not in art:
        rng = np.random.default_rng(SEED + 1)
        sub = np.sort(rng.choice(N, size=min(2_000_000, N // 2), replace=False))
        sub_pts = np.asarray(pts[sub], np.float32)
        sub_clusters = partition_to_clusters(art["assign"][sub], SHARDS)
        opts = KMeansTreeRouterOptions(num_centroids=32, budget=40_000)
        kmtr = KMeansTreeRouter(metric="mips").train(
            sub_pts, sub_clusters, opts, seed=SEED)
        art["routing_points"], art["routing_labels"] = kmtr.extract_points()
        np.savez(cache, **art)
        log(f"router trained ({len(art['routing_points'])} pts)")

    kth = kth_neighbor_distance(art["gt_dists"], K)
    assign = np.asarray(art["assign"])
    clusters = partition_to_clusters(assign, SHARDS)
    q_dev = jnp.asarray(q)

    if "extra_cluster" not in art:
        # overlap assignments: aggs as cluster representatives (same objects
        # the capacity assignment routed with), cheapest-first admission
        from gpann_tpu.gp.overlap import centroid_overlap_streamed

        t0 = time.time()
        cap2 = int((1.0 + 0.05) * (1.0 + OVERLAP) * N / SHARDS)
        ep, ec = centroid_overlap_streamed(
            pts, assign, art["aggs"], art["agg_lbl"], SHARDS, cap2,
            int(OVERLAP * N), keep=KEEP, metric="mips")
        art["extra_point"], art["extra_cluster"] = ep, ec
        art["overlap_build_s"] = np.float64(time.time() - t0)
        np.savez(cache, **art)
        log(f"overlap picked {len(art['extra_point'])} extras in "
            f"{float(art['overlap_build_s']):.0f}s")

    from gpann_tpu.gp.overlap import apply_extra_assignments

    cover = apply_extra_assignments(clusters, art["extra_point"],
                                    art["extra_cluster"])

    out = {"overlap": OVERLAP, "num_extra": int(len(art["extra_point"]))}
    for name, cl in (("gp", clusters), ("gp_overlap", cover)):
        ckey = f"curve_{name}"
        if ckey not in art:
            engine = ServingEngine(
                pts, cl, art["routing_points"], art["routing_labels"],
                metric="mips", scan_mode="binned", voting_impl="approx",
        interpret=bool(os.environ.get("GPANN_SMOKE")))
            curve = engine.recall_curve(q_dev, K, kth, voting_t=VOTING_T,
                                        rule=RULE, query_block=QB)
            art[ckey] = curve
            art[f"cap_{name}"] = np.int64(engine.capacity)
            np.savez(cache, **art)
            del engine
        curve = np.asarray(art[ckey])
        npb = probes_at(curve, TARGET)
        if name == "gp":
            ocurve = oracle_recall(art["gt_ids"], partition=assign,
                                   num_shards=SHARDS)
        else:
            from gpann_tpu.core.partition import clusters_to_cover

            ocurve = oracle_recall(art["gt_ids"],
                                   cover=clusters_to_cover(cl, n=N),
                                   num_shards=SHARDS)
        out[name] = {
            "probes_at_095": npb,
            "recall_at_that": round(float(curve[npb - 1]), 4),
            "scanned_rows_at_095": int(npb * int(art[f"cap_{name}"])),
            "oracle_probes_at_095": probes_at(ocurve, TARGET),
            "curve12": [round(float(r), 4) for r in curve[:12]],
        }
        log(f"{name}: probes@0.95={npb} "
            f"(oracle {out[name]['oracle_probes_at_095']})")

    os.makedirs("exp_outputs", exist_ok=True)
    suffix = "_smoke" if os.environ.get("GPANN_SMOKE") else ""
    with open(f"exp_outputs/mips_overlap_8m{suffix}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
