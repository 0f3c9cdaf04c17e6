"""Scan A/B on one GPU at the headline configuration (bench.py).

Times, in one process on one card:
- serving: the binned engine (Pallas bin-top-2 kernel) against the exact
  engine (XLA matmul + top_k), per-dispatch median over 10 batches, plus the
  approx_max_k variants of the vote set and the candidate-bin pick;
- brute full scan: ``fused_topk`` against ``topk_neighbors``;
- recall@10 after rescore of the exact engine at HIGH (TF32) and HIGHEST.

Every configuration runs twice, in the order A B B A. Prints one JSON line
per measurement, each with the card's name and power limit.

    python exp_scripts/scan_ab.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

K = 10


def timed(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from gpann_tpu.core.device import card, require_gpu
    from gpann_tpu.core.distances import topk_neighbors
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval import kth_neighbor_distance, recall_from_ids
    from gpann_tpu.search.pallas_scan import fused_topk, pad_base_for_scan
    from gpann_tpu.search.serve import ServingEngine

    device = require_gpu()
    card_line = card()
    pts, q, art = bench.load_problem()
    kth = kth_neighbor_distance(art["gt_dists"], K)
    q_dev = jnp.asarray(q)

    def emit(**row):
        row.update(card=card_line, device_kind=device["kind"])
        print(json.dumps(row), flush=True)

    # brute full scan
    padded, nv = pad_base_for_scan(pts)
    pj, xj = jnp.asarray(padded), jnp.asarray(pts)
    del padded
    brute = {"fused_topk": lambda: fused_topk(q_dev, pj, nv, K),
             "topk_neighbors": lambda: topk_neighbors(q_dev, xj, K)}
    for name in ("fused_topk", "topk_neighbors", "topk_neighbors",
                 "fused_topk"):
        rec = recall_from_ids(pts, q, np.asarray(brute[name]()[1]), kth, K)
        emit(what="brute", impl=name, ms=timed(brute[name], 5) * 1e3,
             recall=round(float(rec), 5))
    del pj, xj, brute

    clusters = partition_to_clusters(art["assign"], bench.SHARDS)
    rp, rl = art["routing_points"], art["routing_labels"]
    kw = dict(voting_t=bench.VOTING_T, rule=bench.RULE,
              query_block=bench.QUERY_BLOCK)
    configs = {
        "binned": dict(scan_mode="binned"),
        "binned+approx_vote": dict(scan_mode="binned", voting_impl="approx"),
        "binned+approx_phase2": dict(scan_mode="binned",
                                     scan_phase2="approx"),
        "exact_HIGH": dict(scan_mode="exact"),
        "exact_HIGHEST": dict(scan_mode="exact",
                              precision=jax.lax.Precision.HIGHEST),
    }
    order = ["binned", "exact_HIGH", "binned+approx_vote",
             "binned+approx_phase2", "exact_HIGHEST",
             "exact_HIGHEST", "binned+approx_phase2", "binned+approx_vote",
             "exact_HIGH", "binned"]
    engines = {}
    for name in order:
        if name not in engines:
            engines[name] = ServingEngine(pts, clusters, rp, rl,
                                          **configs[name])
        eng = engines[name]
        nprobes = bench.choose_nprobes(eng, q_dev, kth, art)
        _, ids = eng.serve(q_dev, K, nprobes, **kw)
        rec = recall_from_ids(pts, q, ids, kth, K)
        ms = timed(lambda: eng.serve_device(q_dev, K, nprobes, **kw), 10)
        emit(what="serve", impl=name, nprobes=nprobes, ms_per_batch=ms * 1e3,
             qps=bench.NQ / ms, recall=round(float(rec), 5))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
