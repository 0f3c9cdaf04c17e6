"""In-shard search sweep: per-(shard, query) hit/time measurement.

Reference parity: ``RunInShardSearches`` (shard_searches.cpp:11-104): for
each shard, for each ef in the sweep, run every query through the shard's
index, record which returned points are within the query's GT k-distance
("hits", ``:80-91``) and the median-of-reps amortized per-query time
(``:57-75``).

Redesign: the ef knob is the two-level IVF's ``sub_nprobe`` (see
``two_level.py``); a "run" is one batched grouped scan per shard, timed with
device sync, with hits extracted by the identical dist <= d_k rule.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from gpann_tpu.core.distances import Metric
from gpann_tpu.core.partition import Clusters
from gpann_tpu.core.timer import time_fn
from gpann_tpu.eval.combination import ShardSearch
from gpann_tpu.search.two_level import TwoLevelIVF

# 9-step ef-equivalent grid, matching the reference's 9 ef_search values
# {50,80,100,150,200,250,300,400,500} (shard_searches.cpp:13)
SUB_NPROBE_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16, 24)


def run_in_shard_searches(
    points: np.ndarray,
    queries: np.ndarray,
    clusters: Clusters,
    kth_dist: np.ndarray,
    k: int,
    metric: Metric = "l2",
    sub_nprobe_sweep: Sequence[int] = SUB_NPROBE_SWEEP,
    target_sub_size: int = 4096,
    seed: int = 555,
    timing_reps: int = 3,
    rel_eps: float = 1e-4,
) -> List[ShardSearch]:
    """Returns one ShardSearch per sub_nprobe config."""
    index = TwoLevelIVF(
        points, clusters, metric=metric, target_sub_size=target_sub_size,
        seed=seed,
    )
    num_shards = len(clusters)
    m = len(queries)
    out: List[ShardSearch] = []
    max_subs = index.max_subs_per_shard
    done = set()
    for sub_nprobe in sub_nprobe_sweep:
        sub_nprobe = min(sub_nprobe, max_subs)  # clamp to exact coverage
        if sub_nprobe in done:
            continue
        done.add(sub_nprobe)
        times = np.zeros((num_shards, m), np.float64)
        hits: List[List[np.ndarray]] = []
        for b in range(num_shards):
            probes = np.full((m, 1), b, np.int32)
            t, (d, i) = time_fn(
                index.search, queries, probes, k, sub_nprobe,
                reps=timing_reps, warmup=1,
            )
            times[b, :] = t / m  # amortized per query (shard_searches.cpp:75)
            thresh = kth_dist * (1.0 + rel_eps) + 1e-5
            shard_hits = [
                i[q][(d[q] <= thresh[q]) & (i[q] >= 0)].astype(np.int64)
                for q in range(m)
            ]
            hits.append(shard_hits)
        out.append(
            ShardSearch(ef_search=sub_nprobe, time_query_in_shard=times,
                        hits=hits)
        )
    return out
