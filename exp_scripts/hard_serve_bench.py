"""Chip-measured serving QPS at recall@10 >= 0.95 on the HARD mixture.

VERDICT r3 missing #4 / weak #1: every resident-engine QPS figure so far
rode the separable `blobs` mixture, where the GP cut is clean enough that
nprobes=1 matches brute recall — the recall-vs-QPS trade-off the system
exists to navigate (route_search_combination.cpp:121-226) is degenerate
there. This driver measures the same 8M/32 resident pipeline on the
non-separable `hard` mixture (eval/synth.py), where routing genuinely costs
probes: recall curve -> smallest nprobes >= 0.95 -> windowed serve QPS.

Separate from bench.py on purpose: BENCH_r0N.json keeps its metric/dataset
fixed for cross-round comparability; this emits its own JSON line +
exp_outputs/hard_serve_8m.json.

Usage: python exp_scripts/hard_serve_bench.py  (~40-60 min cold, minutes warm)
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
TARGET = 0.95
SEED = 555
VOTING_T = 60       # hard routes are ambiguous; blobs' T=32 is too few here
RULE = "min_dist"
QUERY_BLOCK = 128
WINDOW = 32

_T0 = time.time()


def log(msg):
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    import jax.numpy as jnp

    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval import kth_neighbor_distance, recall_from_ids
    from gpann_tpu.eval.synth import dataset_cached, generate_queries, make_params, _gen_chunk
    from gpann_tpu.route import KMeansTreeRouter, KMeansTreeRouterOptions
    from gpann_tpu.search.serve import ServingEngine

    from gpann_tpu import artifact_dir

    cache_dir = artifact_dir()
    os.makedirs(cache_dir, exist_ok=True)
    pts, _ = dataset_cached("hard", N, D, SEED)
    q = generate_queries("hard", NQ, D, SEED)
    log(f"data ready {pts.shape}")

    cache = os.path.join(cache_dir, f"hardserve_{SEED}_{N}_{D}_{NQ}_{SHARDS}.npz")
    art = dict(np.load(cache)) if os.path.exists(cache) else {}
    dirty = False
    if "assign" not in art and not os.environ.get("GPANN_SMOKE"):
        # cold-start bootstrap from the repo-shipped compact artifact (same
        # discipline as bench.py): GT + GP partition + router cost ~50 min
        # to recompute
        repo_art = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "exp_artifacts", "hardserve_8m_cache.npz")
        if os.path.exists(repo_art):
            art = dict(np.load(repo_art))
            art["assign"] = art["assign"].astype(np.int32)
            art["gt_ids"] = art["gt_ids"].astype(np.int64)
            dirty = True
            log("artifact cache bootstrapped from repo (exp_artifacts/)")

    if "gt_ids" not in art:
        if os.environ.get("GPANN_SMOKE"):  # no pallas on the CPU backend
            from gpann_tpu.eval.recall import compute_ground_truth

            gt_ids, gt_dists = compute_ground_truth(pts, q, K)
            art["gt_ids"], art["gt_dists"] = gt_ids, gt_dists
        else:
            from gpann_tpu.eval.recall import verify_ground_truth
            from gpann_tpu.search.pallas_scan import fused_topk, pad_base_for_scan

            padded0, nv0 = pad_base_for_scan(pts)
            pj0 = jnp.asarray(padded0)
            gt_raw = np.asarray(fused_topk(jnp.asarray(q), pj0, nv0, 2 * K)[1])
            gt_ids, gt_dists = verify_ground_truth(
                pts, q, gt_raw.astype(np.int64), np.full(gt_raw.shape, np.nan))
            art["gt_ids"], art["gt_dists"] = gt_ids[:, :K], gt_dists[:, :K]
            del pj0, padded0
        dirty = True
        log("ground truth computed")
    if "assign" not in art:
        from gpann_tpu.gp.scale import subsample_gp_partition

        t0 = time.time()
        art["assign"] = subsample_gp_partition(
            pts, k=SHARDS, eps=0.05, seed=SEED,
            num_subsample=1_000_000, num_aggregate=4096)
        art["build_time"] = np.float64(time.time() - t0)
        dirty = True
        log(f"GP partition in {float(art['build_time']):.0f}s")
    kth = kth_neighbor_distance(art["gt_dists"], K)
    clusters = partition_to_clusters(art["assign"], SHARDS)

    if "routing_points" not in art:
        rng = np.random.default_rng(SEED + 1)
        sub = np.sort(rng.choice(N, size=min(2_000_000, N // 2), replace=False))
        sub_pts = np.asarray(pts[sub], np.float32)
        sub_clusters = partition_to_clusters(art["assign"][sub], SHARDS)
        # bigger router than the blobs bench (10k): hard boundaries need
        # finer routing detail (the reference's budget n/s would be 250k;
        # 40k measured a good size/recall tradeoff at this scale)
        opts = KMeansTreeRouterOptions(num_centroids=32, budget=40_000)
        kmtr = KMeansTreeRouter().train(sub_pts, sub_clusters, opts, seed=SEED)
        art["routing_points"], art["routing_labels"] = kmtr.extract_points()
        dirty = True
        log(f"router trained ({len(art['routing_points'])} pts)")
    if dirty:
        np.savez(cache, **art)

    q_dev = jnp.asarray(q)
    q_dev.block_until_ready()

    engine = ServingEngine(
        pts, clusters, art["routing_points"], art["routing_labels"],
        scan_mode="binned", voting_impl="approx",
        interpret=bool(os.environ.get("GPANN_SMOKE")))
    log("engine resident")

    if "nprobes" not in art:
        curve = engine.recall_curve(q_dev, K, kth, voting_t=VOTING_T,
                                    rule=RULE, query_block=QUERY_BLOCK)
        ok = np.nonzero(curve >= TARGET)[0]
        art["nprobes"] = np.int64(ok[0] + 1 if len(ok) else SHARDS)
        art["curve"] = curve
        np.savez(cache, **art)
        log("recall curve: "
            + " ".join(f"{p+1}:{r:.4f}" for p, r in enumerate(curve)))
    nprobes = int(art["nprobes"])

    d0, i0 = engine.serve(q_dev, K, nprobes, voting_t=VOTING_T, rule=RULE,
                          query_block=QUERY_BLOCK)
    recall = recall_from_ids(pts, q, i0, kth, K)
    log(f"nprobes={nprobes} recall={recall:.4f}")

    # distinct hard-mixture batches for the window
    rng_w = np.random.default_rng(SEED + 2)
    params = make_params("hard", D, SEED)
    pool = _gen_chunk("hard", WINDOW * NQ, D, SEED, 0x7E58, params)
    batches = jnp.asarray(pool.reshape(WINDOW, NQ, D))
    batches.block_until_ready()

    def serve_window():
        return engine.serve_scan(batches, K, nprobes, voting_t=VOTING_T,
                                 rule=RULE, query_block=QUERY_BLOCK)

    ds, _ = serve_window()
    float(jnp.sum(jnp.where(jnp.isfinite(ds), ds, 0.0)))
    t0 = time.time()
    d1, _ = serve_window()
    d2, _ = serve_window()
    float(jnp.sum(jnp.where(jnp.isfinite(d1), d1, 0.0))
          + jnp.sum(jnp.where(jnp.isfinite(d2), d2, 0.0)))
    lat = (time.time() - t0) / (2 * WINDOW)
    qps = NQ / lat
    log(f"serve: {qps:.0f} qps ({lat*1e3:.1f} ms/batch)")

    out = {
        "metric": f"qps@recall{TARGET}_synthetic-hard{N//1_000_000}M-{SHARDS}shards",
        "value": round(qps, 1), "unit": "qps",
        "recall_at_10": round(float(recall), 4),
        "nprobes": nprobes, "num_shards": SHARDS, "batch": NQ,
        "curve": [round(float(r), 4)
                  for r in np.asarray(art["curve"])[:12]],
        "total_seconds": round(time.time() - _T0, 1),
    }
    os.makedirs("exp_outputs", exist_ok=True)
    suffix = "_smoke" if os.environ.get("GPANN_SMOKE") else ""
    with open(f"exp_outputs/hard_serve_8m{suffix}.json", "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
