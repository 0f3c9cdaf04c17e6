"""Full-graph GP vs subsample-GP fidelity at 8M (VERDICT r3 weak #3).

The reference partitions the kNN graph of the ENTIRE point set even at 1B
(partitioning.cpp:251-264); the repo's scale path (gp/scale.py) builds the
graph on a subsample and Voronoi-extends via per-part aggregates. This
script measures what that approximation costs at the flagship resident
scale, where the full base fits host RAM and the full 8M graph is buildable
on the GPU: same base / GT / queries as exp_scripts/hard_serve_bench.py
(run that first — its cache provides GT + the 1M-subsample GP partition),
plus a full-graph GP partition, compared on

- oracle recall@10 per probe count (partition ceiling, recall.h:41-68), and
- routed recall@10 per probe count (same KMeansTree router recipe both).

Output: exp_outputs/gp_fidelity_8m.csv + one JSON summary line. The
subsample-size policy for 250M-1B follows from the gap (or its absence).

Usage: python exp_scripts/gp_fidelity_8m.py   (~40-70 min cold)
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
VOTING_T = 60
RULE = "min_dist"
QB = 128
TARGET = 0.95

_T0 = time.time()


def log(msg):
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def probes_at(curve, target):
    ok = np.nonzero(np.asarray(curve) >= target)[0]
    return int(ok[0] + 1) if len(ok) else len(curve)


def main() -> int:
    import jax.numpy as jnp

    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval import kth_neighbor_distance
    from gpann_tpu.eval.recall import oracle_recall
    from gpann_tpu.eval.synth import dataset_cached, generate_queries
    from gpann_tpu.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu.search.serve import ServingEngine

    from gpann_tpu import artifact_dir

    cache_dir = artifact_dir()
    hs_cache = os.path.join(cache_dir,
                            f"hardserve_{SEED}_{N}_{D}_{NQ}_{SHARDS}.npz")
    from _hardserve_cache import ensure_hardserve

    if not ensure_hardserve(hs_cache):
        print("run exp_scripts/hard_serve_bench.py first", file=sys.stderr)
        return 1
    art = dict(np.load(hs_cache))
    pts, _ = dataset_cached("hard", N, D, SEED)
    q = generate_queries("hard", NQ, D, SEED)
    kth = kth_neighbor_distance(art["gt_dists"], K)
    log("hardserve cache + base loaded")

    fg_cache = os.path.join(cache_dir, f"gpfull_{SEED}_{N}_{D}_{SHARDS}.npz")
    fg = dict(np.load(fg_cache)) if os.path.exists(fg_cache) else {}
    if "assign" not in fg:
        # the reference's actual GP: kNN graph of ALL 8M points -> balanced
        # LP partition (partitioning.cpp:251-264); no subsample, no
        # aggregate extension
        from gpann_tpu.gp.partitioning import graph_partitioning

        t0 = time.time()
        fg["assign"] = graph_partitioning(
            np.asarray(pts, np.float32), SHARDS, eps=0.05, seed=SEED)
        fg["build_time"] = np.float64(time.time() - t0)
        np.savez(fg_cache, **fg)
        log(f"full-graph GP partition built in {float(fg['build_time']):.0f}s")

    gt_ids = art["gt_ids"]
    rows = []
    summary = {}
    for name, assign, bt in (
        ("subsample_gp", art["assign"], float(art.get("build_time", np.nan))),
        ("fullgraph_gp", fg["assign"], float(fg["build_time"])),
    ):
        assign = np.asarray(assign)
        sizes = np.bincount(assign, minlength=SHARDS)
        balance = sizes.max() / np.ceil(N / SHARDS)
        ocurve = oracle_recall(gt_ids, partition=assign, num_shards=SHARDS)

        rkey = f"routing_points_{name}"
        if rkey not in fg and name == "fullgraph_gp":
            rng = np.random.default_rng(SEED + 1)
            sub = np.sort(rng.choice(N, size=min(2_000_000, N // 2), replace=False))
            sub_pts = np.asarray(pts[sub], np.float32)
            sub_clusters = partition_to_clusters(assign[sub], SHARDS)
            opts = KMeansTreeRouterOptions(num_centroids=32, budget=40_000)
            kmtr = KMeansTreeRouter().train(sub_pts, sub_clusters, opts,
                                            seed=SEED)
            fg[rkey], fg[f"routing_labels_{name}"] = kmtr.extract_points()
            np.savez(fg_cache, **fg)
            log(f"router trained for {name}")
        if name == "subsample_gp":
            rp, rl = art["routing_points"], art["routing_labels"]
        else:
            rp, rl = fg[rkey], fg[f"routing_labels_{name}"]

        ckey = f"curve_{name}"
        if ckey not in fg:
            engine = ServingEngine(
                pts, partition_to_clusters(assign, SHARDS), rp, rl,
                scan_mode="binned", voting_impl="approx",
        interpret=bool(os.environ.get("GPANN_SMOKE")))
            fg[ckey] = engine.recall_curve(
                jnp.asarray(q), K, kth, voting_t=VOTING_T, rule=RULE,
                query_block=QB)
            np.savez(fg_cache, **fg)
            del engine
        rcurve = np.asarray(fg[ckey])
        log(f"{name}: balance={balance:.4f} oracle@1={ocurve[0]:.4f} "
            f"routed probes@{TARGET}={probes_at(rcurve, TARGET)}")
        for p in range(SHARDS):
            rows.append((name, p + 1, float(ocurve[p]), float(rcurve[p]),
                         round(balance, 4), round(bt, 1)))
        summary[name] = {
            "oracle_at_1": round(float(ocurve[0]), 4),
            "oracle_probes_at_target": probes_at(ocurve, TARGET),
            "routed_probes_at_target": probes_at(rcurve, TARGET),
            "routed_at_3": round(float(rcurve[2]), 4),
            "balance": round(float(balance), 4),
            "build_s": round(bt, 1),
        }

    os.makedirs("exp_outputs", exist_ok=True)
    suffix = "_smoke" if os.environ.get("GPANN_SMOKE") else ""
    with open(f"exp_outputs/gp_fidelity_8m{suffix}.csv", "w") as f:
        f.write("method,nprobes,oracle_recall,routed_recall,balance,build_s\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
