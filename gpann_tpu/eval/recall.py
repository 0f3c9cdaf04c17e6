"""Ground truth, recall and oracle recall.

Reference parity: ``src/recall.h``.

- :func:`compute_ground_truth` — brute-force exact kNN of the queries in the
  full base set (``recall.h:10-39``). Here this is one giant blocked
  matmul + running top-k; it runs at HIGHEST matmul precision because ties
  and epsilon comparisons feed the recall definition.
- :func:`kth_neighbor_distance` / :func:`verify_ground_truth` — the
  reference *verifies* downloaded GT files by recomputing distances and
  counting mismatches at 10 tolerance levels, re-sorting when needed
  (``recall.h:74-137``).
- :func:`recall_from_candidate_distances` — recall@k counts returned points
  with ``dist <= d_k(q)`` (distance-threshold definition, handles ties;
  ``recall.h:139-150``).
- :func:`oracle_recall` — best-possible probe order computed from ground
  truth: probe shards in decreasing number of GT neighbors they contain
  (``recall.h:41-68``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from gpann_tpu.core.distances import Metric, chunked_topk_neighbors
from gpann_tpu.core.partition import Cover, Partition


def compute_ground_truth(
    base: np.ndarray,
    queries: np.ndarray,
    k: int,
    metric: Metric = "l2",
    query_block: int = 4096,
    block_rows: int = 262144,
    scan_oversample: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN ids+distances of each query (reference ComputeGroundTruth).

    Two-phase: a HIGH-precision scan (TF32 on the GPU) over-collects
    ``scan_oversample*k + 16`` candidates, then their distances are
    recomputed exactly in f32 and the true top-k selected. A true neighbor is
    only lost if an inter-candidate gap at the oversample boundary is below
    the scan's rounding error — far below the tolerance the reference itself
    accepts when verifying published GT files (recall.h:74-137). Set
    ``scan_oversample=0`` to force the single-phase HIGHEST path.
    """
    import jax

    if scan_oversample <= 0:
        dists, ids = chunked_topk_neighbors(
            queries, base, k, metric=metric, query_block=query_block,
            block_rows=block_rows, precision=jax.lax.Precision.HIGHEST,
        )
        return ids.astype(np.int32), dists.astype(np.float32)

    k_scan = min(scan_oversample * k + 16, base.shape[0])
    _, ids = chunked_topk_neighbors(
        queries, base, k_scan, metric=metric, query_block=query_block,
        block_rows=block_rows, precision=jax.lax.Precision.HIGH,
    )
    sids, sdists = verify_ground_truth(
        base, queries, ids.astype(np.int64), np.full(ids.shape, np.nan), metric
    )
    return sids[:, :k].astype(np.int32), sdists[:, :k].astype(np.float32)


def kth_neighbor_distance(gt_dists: np.ndarray, k: int) -> np.ndarray:
    """Distance to the k-th ground-truth neighbor, per query (recall.h:30-39)."""
    if gt_dists.shape[1] < k:
        raise ValueError(f"ground truth has only {gt_dists.shape[1]} < k={k} columns")
    return gt_dists[:, k - 1].astype(np.float32)


def verify_ground_truth(
    base: np.ndarray,
    queries: np.ndarray,
    gt_ids: np.ndarray,
    gt_dists: np.ndarray,
    metric: Metric = "l2",
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Recompute the distances of published GT ids and repair ordering.

    Mirrors ``ConvertGroundTruthToDistanceToKthNeighbor`` (recall.h:74-137):
    distances are recomputed from the vectors, mismatches counted at 10
    tolerance levels, and each row re-sorted by recomputed distance.
    Returns (sorted ids, sorted recomputed dists).
    """
    from gpann_tpu.core.distances import pairwise_distances
    import jax
    import jax.numpy as jnp

    nq, k = gt_ids.shape
    recomputed = np.empty((nq, k), dtype=np.float32)
    block = 2048
    for s in range(0, nq, block):
        q = jnp.asarray(queries[s : s + block])
        cand = jnp.asarray(base[gt_ids[s : s + block].reshape(-1)]).reshape(
            q.shape[0], k, -1
        )
        if metric == "mips":
            d = 1.0 - jnp.einsum(
                "qd,qkd->qk", q, cand, precision=jax.lax.Precision.HIGHEST
            )
        else:
            d = jnp.sum(
                (q[:, None, :] - cand) ** 2, axis=-1
            )
        recomputed[s : s + block] = np.asarray(d, dtype=np.float32)

    if not np.all(np.isnan(gt_dists)):
        for i, eps in enumerate(10.0 ** -np.arange(1, 11)):
            mism = int((np.abs(recomputed - gt_dists) > eps).sum())
            if verbose:
                print(f"eps=1e-{i+1}: {mism} mismatches")

    order = np.argsort(recomputed, axis=1, kind="stable")
    return (
        np.take_along_axis(gt_ids, order, axis=1),
        np.take_along_axis(recomputed, order, axis=1),
    )


def recall_from_candidate_distances(
    cand_dists: np.ndarray, kth_dist: np.ndarray, k: int,
    eps: float = 1e-5, rel_eps: float = 1e-4,
) -> float:
    """recall@k with the distance-threshold definition (recall.h:139-150).

    ``cand_dists`` [nq, >=k] are distances of the returned candidates (may
    contain inf padding); a candidate is a hit if its distance is within
    ``d_k(q) + eps + rel_eps*|d_k|``. The relative term absorbs f32
    summation-order noise between the GT path and search kernels (the
    reference's single distance function made them bit-identical; our GT and
    kernels use different but equally exact groupings). At most k hits per
    query are counted.
    """
    thresh = kth_dist[:, None] + eps + rel_eps * np.abs(kth_dist[:, None])
    hits = (cand_dists <= thresh).sum(axis=1)
    return float(np.minimum(hits, k).sum()) / (k * len(kth_dist))


def recall_from_hit_counts(hit_counts: np.ndarray, k: int) -> float:
    return float(np.minimum(hit_counts, k).sum()) / (k * len(hit_counts))


def recall_from_ids(
    base: np.ndarray,
    queries: np.ndarray,
    cand_ids: np.ndarray,
    kth_dist: np.ndarray,
    k: int,
    metric: Metric = "l2",
    eps: float = 1e-5,
) -> float:
    """recall@k with candidate distances *recomputed exactly* from ids.

    Search kernels may run at reduced matmul precision; recomputing the
    candidates' distances at full precision keeps the distance-threshold
    recall definition (recall.h:139-150) unbiased regardless of the search
    path's precision. ``cand_ids`` may contain -1 padding.
    """
    import jax
    import jax.numpy as jnp

    m, c = cand_ids.shape
    safe_ids = np.where(cand_ids < 0, 0, cand_ids)
    out = np.empty((m, c), dtype=np.float32)
    block = 2048
    for s in range(0, m, block):
        q = jnp.asarray(queries[s : s + block])
        cand = jnp.asarray(base[safe_ids[s : s + block].reshape(-1)]).reshape(
            q.shape[0], c, -1
        )
        if metric == "mips":
            d = 1.0 - jnp.einsum(
                "qd,qkd->qk", q, cand, precision=jax.lax.Precision.HIGHEST
            )
        else:
            d = jnp.sum((q[:, None, :] - cand) ** 2, axis=-1)
        out[s : s + block] = np.asarray(d, np.float32)
    out = np.where(cand_ids < 0, np.inf, out)
    # dedup ids per query so overlapping shards can't double-count a point:
    # sort columns by id (copies of an id are adjacent and share one exact
    # distance), mask all but the first copy, scatter the mask back —
    # vectorized so 100k-query sets stay tractable on the single-core host
    ordix = np.argsort(cand_ids, axis=1, kind="stable")
    sids = np.take_along_axis(cand_ids, ordix, axis=1)
    dup_sorted = np.zeros_like(sids, dtype=bool)
    dup_sorted[:, 1:] = (sids[:, 1:] == sids[:, :-1]) & (sids[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, ordix, dup_sorted, axis=1)
    out = np.where(dup, np.inf, out)
    return recall_from_candidate_distances(out, kth_dist, k, eps=eps)


def gt_shard_counts(
    gt_ids: np.ndarray, partition: Optional[Partition] = None,
    cover: Optional[Cover] = None, num_shards: Optional[int] = None,
) -> np.ndarray:
    """[nq, num_shards] — how many GT neighbors of each query live in each
    shard. With a cover (overlap) a neighbor counts in *every* shard holding
    it (matches OracleRecall's first-come-dedup upper bound when probing)."""
    nq, k = gt_ids.shape
    if partition is not None:
        s = num_shards or int(partition.max()) + 1
        counts = np.zeros((nq, s), dtype=np.int32)
        shard_of = partition[gt_ids]  # [nq, k]
        for j in range(k):
            np.add.at(counts, (np.arange(nq), shard_of[:, j]), 1)
        return counts
    assert cover is not None
    from gpann_tpu.core.partition import cover_to_csr, csr_gather

    s = num_shards or int(max((c.max() for c in cover if len(c)), default=-1)) + 1
    counts = np.zeros((nq, s), dtype=np.int32)
    indptr, indices = cover_to_csr(cover)
    owners, shards = csr_gather(indptr, indices, gt_ids.reshape(-1))
    np.add.at(counts, (owners // k, shards), 1)
    return counts


def oracle_recall(
    gt_ids: np.ndarray,
    partition: Optional[Partition] = None,
    cover: Optional[Cover] = None,
    num_shards: Optional[int] = None,
) -> np.ndarray:
    """Best-possible cumulative recall per #probes (recall.h:41-68).

    Probe shards in decreasing GT-neighbor count per query; with overlap each
    neighbor is counted once (cover handling mirrors oracle_recall.cpp:10-38's
    dedup across probes). Returns [num_shards] cumulative recall@k curve.
    """
    nq, k = gt_ids.shape
    if cover is None:
        counts = gt_shard_counts(gt_ids, partition=partition, num_shards=num_shards)
        sorted_counts = -np.sort(-counts, axis=1)
        cum = np.cumsum(sorted_counts, axis=1)
        return cum.sum(axis=0) / (k * nq)
    # overlap: greedy max-coverage per query (neighbors dedup across probes),
    # vectorized over queries: membership tensor M[q, b, j] = "GT neighbor j
    # of query q lives in shard b", then s rounds of masked argmax — keeps
    # 100k-query sets tractable on the single-core host
    from gpann_tpu.core.partition import cover_to_csr, csr_gather

    s = num_shards or int(max((c.max() for c in cover if len(c)), default=-1)) + 1
    M = np.zeros((nq, s, k), dtype=bool)
    indptr, indices = cover_to_csr(cover)
    owners, shards = csr_gather(indptr, indices, gt_ids.reshape(-1))
    M[owners // k, shards, owners % k] = True
    covered = np.zeros((nq, k), dtype=bool)
    total = np.zeros(s, dtype=np.int64)
    rows = np.arange(nq)
    for probe in range(s):
        gains = (M & ~covered[:, None, :]).sum(axis=2)  # [nq, s]
        best = gains.argmax(axis=1)  # first max, like the python max()
        covered |= M[rows, best]
        total[probe] = int(covered.sum())
        M[rows, best] = False
    return total / (k * nq)


def max_first_shard_routing_recall(
    gt_ids: np.ndarray, probe_orders: Sequence[np.ndarray],
    partition: Partition,
) -> float:
    """Fraction of GT neighbors captured by the first probed shard
    (reference MaxFirstShardRoutingRecall, routes.cpp:11-31)."""
    counts = gt_shard_counts(gt_ids, partition=partition)
    k = gt_ids.shape[1]
    first = np.asarray([po[0] for po in probe_orders])
    return float(counts[np.arange(len(first)), first].sum()) / (k * len(first))
