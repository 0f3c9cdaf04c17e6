"""Headline benchmark: QPS at recall@10 >= 0.95 on one GPU, on a synthetic
clustered 8M x 96 dataset (DEEP-like shape), 32 shards of ~250k points.

Shard size (~250k) is held constant as N grows — the reference's own scaling
model (1B points / 40-60 shards over hosts, README bullet 6): routed serving
cost stays ~constant in N while brute force grows linearly, which is the
entire point of the partitioned design.

Pipeline measured (the reference's SmallScaleQueries configuration, C19):
**GP partition** — the reference's flagship method (subsample kNN graph +
balanced LP partition + capacity stream-assignment, partitioning.cpp:
251-264 + 305-356) -> k-means-tree router (extracted points, flat matmul
scan) -> fused serving engine with the Pallas bin-top-2 scan kernel (route +
group + scan + merge in one XLA program; exact f32 candidate rescore).

The deterministic artifacts of this configuration (ground truth, GP
partition, routing points, the chosen nprobes) ship in
``exp_artifacts/bench_8m_gp_cache.npz``, like the reference caches ground
truth (run_query_attribution.cpp:46-55); a run regenerates only the seeded
data. A missing artifact is recomputed in memory.

``vs_baseline`` = measured QPS / brute-force full-scan QPS (the same kernel
over the whole base) on the same card — the throughput multiple the
partitioned GP-ANN design buys over exact scanning at (near-)equal recall.
The reference publishes no absolute numbers (BASELINE.md).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras},
with the device and the card's power limit. Fails without a GPU.
"""

import json
import os
import sys
import time

import numpy as np

N, D, NQ, SHARDS, K = 8_000_000, 96, 4096, 32, 10
TARGET_RECALL = 0.95
SEED = 555
VOTING_T = 32  # GP routes are unambiguous; fewer votes, same recall
RULE = "min_dist"
QUERY_BLOCK = 128
# lax.top_k for the vote set and the candidate-bin pick: approx_max_k lowers
# to an exact selection on the GPU and measured no faster (PERF.md)
VOTING_IMPL = "exact"
SCAN_PHASE2 = "exact"
WINDOW = 32  # batches per serve_scan window
ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "exp_artifacts", "bench_8m_gp_cache.npz")

_T0 = time.time()


def log(msg: str) -> None:
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def load_problem():
    """(base [N, D], queries [NQ, D], artifacts dict) of the benchmark
    configuration. Artifacts missing from the shipped file are recomputed."""
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval.synth import blobs

    pts, q = blobs(N, D, NQ, SEED)
    log(f"data generated: {pts.shape}")
    art = dict(np.load(ARTIFACT)) if os.path.exists(ARTIFACT) else {}
    if "gt_ids" not in art:
        import jax.numpy as jnp

        from gpann_tpu.eval.recall import verify_ground_truth
        from gpann_tpu.search.pallas_scan import fused_topk, pad_base_for_scan

        padded, nv = pad_base_for_scan(pts)
        gt_raw = np.asarray(fused_topk(jnp.asarray(q), jnp.asarray(padded),
                                       nv, 2 * K)[1])
        gt_ids, gt_dists = verify_ground_truth(
            pts, q, gt_raw.astype(np.int64), np.full(gt_raw.shape, np.nan))
        art["gt_ids"], art["gt_dists"] = gt_ids[:, :K], gt_dists[:, :K]
        log("ground truth computed")
    if "assign" not in art:
        from gpann_tpu.gp.scale import subsample_gp_partition

        art["assign"] = subsample_gp_partition(
            pts, k=SHARDS, eps=0.05, seed=SEED,
            num_subsample=1_000_000, num_aggregate=4096,
        )
        log("GP partition computed")
    if "routing_points" not in art:
        from gpann_tpu.route import KMeansTreeRouter, KMeansTreeRouterOptions

        # train on a 2M subsample (the reference's big-input strategy,
        # partitioning.cpp:271-276); a 10k-point budget routes the GP
        # partition as well as a 40k one
        rng = np.random.default_rng(SEED + 1)
        sub = np.sort(rng.choice(N, size=min(2_000_000, N), replace=False))
        opts = KMeansTreeRouterOptions(num_centroids=32, budget=10_000)
        kmtr = KMeansTreeRouter().train(
            pts[sub], partition_to_clusters(art["assign"][sub], SHARDS),
            opts, seed=SEED)
        art["routing_points"], art["routing_labels"] = kmtr.extract_points()
        log(f"router trained ({len(art['routing_points'])} points)")
    art["assign"] = art["assign"].astype(np.int32)
    art["gt_ids"] = art["gt_ids"].astype(np.int64)
    return pts, q, art


def build_engine(pts, art):
    """The benchmark's resident serving engine (binned scan kernel)."""
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.search.serve import ServingEngine

    return ServingEngine(
        pts, partition_to_clusters(art["assign"], SHARDS),
        art["routing_points"], art["routing_labels"],
        scan_mode="binned", voting_impl=VOTING_IMPL, scan_phase2=SCAN_PHASE2,
    )


def choose_nprobes(engine, q_dev, kth, art) -> int:
    """The shipped nprobes, or the smallest probe count whose recall@10
    reaches TARGET_RECALL (one compiled recall-curve program)."""
    if "nprobes" not in art:
        curve = engine.recall_curve(q_dev, K, kth, voting_t=VOTING_T,
                                    rule=RULE, query_block=QUERY_BLOCK)
        ok = np.nonzero(curve >= TARGET_RECALL)[0]
        art["nprobes"] = ok[0] + 1 if len(ok) else SHARDS
    return int(art["nprobes"])


def _timed(fn, reps: int) -> float:
    """Median seconds of ``fn`` over ``reps`` runs after one warm-up."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> int:
    import jax.numpy as jnp

    from gpann_tpu.core.device import card, power_limit_w, require_gpu
    from gpann_tpu.eval import kth_neighbor_distance, recall_from_ids
    from gpann_tpu.eval.synth import blob_queries
    from gpann_tpu.search.pallas_scan import fused_topk, pad_base_for_scan

    device = require_gpu()
    card_line = card()
    log(f"{device} | {card_line}")
    pts, q, art = load_problem()
    kth = kth_neighbor_distance(art["gt_dists"], K)
    q_dev = jnp.asarray(q)

    # brute-force full-scan baseline FIRST, before the engine is resident:
    # the same kernel over the whole base, so vs_baseline isolates the
    # partitioning/routing advantage, not kernel quality
    padded, n_valid = pad_base_for_scan(pts)
    pj = jnp.asarray(padded)
    del padded
    _, bi = fused_topk(q_dev, pj, n_valid, K)
    brute_recall = recall_from_ids(pts, q, np.asarray(bi), kth, K)
    brute_lat = _timed(lambda: fused_topk(q_dev, pj, n_valid, K), reps=5)
    brute_qps = NQ / brute_lat
    del pj
    log(f"brute: {brute_qps:.0f} qps recall={brute_recall:.4f}")

    engine = build_engine(pts, art)
    log(f"engine resident (voting={VOTING_IMPL} phase2={SCAN_PHASE2})")
    nprobes = choose_nprobes(engine, q_dev, kth, art)
    serve_kw = dict(voting_t=VOTING_T, rule=RULE, query_block=QUERY_BLOCK)

    _, i0 = engine.serve(q_dev, K, nprobes, **serve_kw)
    recall = recall_from_ids(pts, q, i0, kth, K)
    log(f"nprobes={nprobes} recall={recall:.4f}")
    dispatch_lat = _timed(
        lambda: engine.serve_device(q_dev, K, nprobes, **serve_kw), reps=10)
    log(f"serve (per-dispatch): {NQ / dispatch_lat:.0f} qps "
        f"({dispatch_lat * 1e3:.2f} ms/batch)")

    # steady state: a window of DISTINCT batches served by one program
    # (lax.scan over the batch axis), one dispatch per window
    batches = jnp.asarray(blob_queries(WINDOW * NQ, D, SEED, SEED + 2)
                          .reshape(WINDOW, NQ, D))
    window_lat = _timed(
        lambda: engine.serve_scan(batches, K, nprobes, **serve_kw), reps=3)
    qps = NQ * WINDOW / window_lat
    log(f"serve: {qps:.0f} qps ({window_lat / WINDOW * 1e3:.2f} ms/batch, "
        f"{WINDOW}-batch windows)")

    print(json.dumps({
        "metric": f"qps@recall{TARGET_RECALL}_synthetic-deep"
                  f"{N // 1_000_000}M-{SHARDS}shards",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / brute_qps, 3),
        "recall_at_10": round(float(recall), 4),
        "nprobes": nprobes,
        "num_shards": SHARDS,
        "brute_force_qps": round(brute_qps, 1),
        "brute_force_recall_at_10": round(float(brute_recall), 4),
        "per_dispatch_qps": round(NQ / dispatch_lat, 1),
        "batch": NQ,
        "total_seconds": round(time.time() - _T0, 1),
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "card": card_line,
        "power_limit_w": power_limit_w(card_line),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
