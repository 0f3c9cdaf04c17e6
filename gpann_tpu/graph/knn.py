"""kNN-graph construction: exact oracle + approximate leader-sketching builder.

Reference parity: ``src/knn_graph.h``.

- :func:`build_exact_knn_graph` — O(n^2) oracle (``knn_graph.h:30-34``).
- :class:`ApproximateKNNGraphBuilder` — REPETITIONS x recursive leader
  sketching (``knn_graph.h:52-143``): sample leaders, assign each point to
  FANOUT closest leaders, merge tiny clusters (``:100-112``), random-split
  base case for near-duplicates (``:120-130``), recurse until
  <= MAX_CLUSTER_SIZE, then brute-force all pairs within each bucket and merge
  per-point top-k across buckets with dedup (``:165-250``). Tuning constants
  mirror ``knn_graph.h:254-265``.

Accelerator redesign:

- Graphs are dense ``[n, num_neighbors]`` int32 arrays (every node has exactly
  k out-neighbors, like the reference's AdjGraph rows) — XLA-friendly, and
  symmetrization produces CSR on host.
- Leader assignment = tall ``[ids, leaders]`` distance matmul + top-fanout
  (``ClosestLeaders``, defs.cpp:87-96) as a matmul.
- Bucket brute-force = buckets grouped by padded size, stacked, and crunched
  by a scanned ``[cap, cap]`` distance matmul + top-k per group — the
  spin-locked heap merge becomes a vectorized host merge with dedup.
- Recursion/bucketing bookkeeping stays on host (irregular control flow).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpann_tpu.core.distances import Metric, sq_norms, topk_neighbors

Graph = np.ndarray  # [n, num_neighbors] int32 neighbor ids


def build_exact_knn_graph(
    points: np.ndarray, num_neighbors: int, metric: Metric = "l2",
    block_rows: int = 65536, query_block: int = 8192,
) -> Graph:
    """Exact kNN graph (oracle; reference BuildExactKNNGraph, knn_graph.h:30-34)."""
    from gpann_tpu.core.distances import chunked_topk_neighbors

    _, ids = chunked_topk_neighbors(
        points, points, num_neighbors + 1, metric=metric,
        query_block=query_block, block_rows=block_rows,
    )
    return _drop_self(ids, num_neighbors)


def _drop_self(ids: np.ndarray, k: int) -> np.ndarray:
    """Remove each point's self-match from a top-(k+1) list (order preserved)."""
    is_self = ids == np.arange(ids.shape[0])[:, None]
    push_back = np.argsort(is_self, axis=1, kind="stable")  # self (True) last
    return np.take_along_axis(ids, push_back, axis=1)[:, :k].astype(np.int32)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _crunch_group(bucket_points, bucket_sizes, k: int, metric: Metric):
    """All-pairs top-k inside each padded bucket of one size group.

    bucket_points [nb, cap, d]; returns (dists [nb, cap, k], local ids)."""

    def one(block, size):
        dots = jnp.dot(block, block.T, preferred_element_type=jnp.float32)
        if metric == "mips":
            dm = 1.0 - dots
        else:
            sq = sq_norms(block)
            dm = sq[:, None] + sq[None, :] - 2.0 * dots
        cap = block.shape[0]
        valid = jnp.arange(cap) < size
        mask = valid[None, :] & valid[:, None]
        mask &= ~jnp.eye(cap, dtype=bool)  # no self edges (j != i, knn_graph.h:172)
        dm = jnp.where(mask, dm, jnp.inf)
        neg, pos = jax.lax.top_k(-dm, k)
        return -neg, pos

    def body(carry, inp):
        block, size = inp
        return carry, one(block, size)

    _, (d, i) = jax.lax.scan(body, None, (bucket_points, bucket_sizes))
    return d, i


class ApproximateKNNGraphBuilder:
    """Recursive leader-sketching approximate kNN-graph builder."""

    # tuning constants: parity with knn_graph.h:254-265
    FRACTION_LEADERS = 0.005
    TOP_LEVEL_NUM_LEADERS = 950
    MAX_NUM_LEADERS = 1500
    MAX_CLUSTER_SIZE = 5000
    MIN_CLUSTER_SIZE = 50
    MAX_MERGED_CLUSTER_SIZE = 2500
    REPETITIONS = 3
    FANOUT = 3
    MAX_DEPTH = 14
    CONCERNING_DEPTH = 10
    TOO_SMALL_SHRINKAGE_FRACTION = 0.8

    def __init__(self, metric: Metric = "l2", seed: int = 555, quiet: bool = True,
                 strong: bool = False):
        self.metric: Metric = metric
        self.seed = seed
        self.quiet = quiet
        if strong:  # GraphPartitioning 'strong' preset (partitioning.cpp:253-257)
            self.FANOUT = 5
            self.REPETITIONS = 5

    # -- sketching ------------------------------------------------------------
    def _closest_leaders(
        self, points: np.ndarray, ids: np.ndarray, leaders: np.ndarray, fanout: int
    ) -> np.ndarray:
        """[len(ids), fanout] leader indices (into ``leaders``) per point.

        The query side is padded to power-of-two row buckets so the recursion
        reuses O(log n) compiled shapes instead of one per node (each fresh
        compile costs 20-75 s on this backend)."""
        m = len(ids)
        m_pad = max(256, 1 << (m - 1).bit_length())
        qpts = np.zeros((m_pad, points.shape[1]), np.float32)
        qpts[:m] = points[ids]
        _, idx = topk_neighbors(
            jnp.asarray(qpts),
            jnp.asarray(points[leaders]),
            min(fanout, len(leaders)),
            metric=self.metric,
        )
        return np.asarray(idx)[:m]

    def _sketch(
        self, points: np.ndarray, ids: np.ndarray, depth: int, fanout: int,
        rng: np.random.Generator,
    ) -> List[np.ndarray]:
        if len(ids) <= self.MAX_CLUSTER_SIZE:
            return [ids]
        num_leaders = (
            self.TOP_LEVEL_NUM_LEADERS
            if depth == 0
            else int(len(ids) * self.FRACTION_LEADERS)
        )
        num_leaders = max(4, min(num_leaders, self.MAX_NUM_LEADERS))
        # round the leader count to a power of two: it is a sampling-size
        # heuristic (knn_graph.h:62-67), and shape bucketing bounds compiles
        num_leaders = 1 << (num_leaders - 1).bit_length()
        num_leaders = min(num_leaders, len(ids))
        leaders = rng.choice(ids, size=num_leaders, replace=False)

        closest = self._closest_leaders(points, ids, leaders, fanout)
        fanout_eff = closest.shape[1]
        # group points by leader (parlay group_by_index, knn_graph.h:83)
        flat_leader = closest.reshape(-1)
        flat_point = np.repeat(ids, fanout_eff)
        order = np.argsort(flat_leader, kind="stable")
        sorted_leader = flat_leader[order]
        sorted_point = flat_point[order]
        boundaries = np.searchsorted(sorted_leader, np.arange(num_leaders + 1))
        clusters = [
            sorted_point[boundaries[i] : boundaries[i + 1]]
            for i in range(num_leaders)
        ]

        # sort by size desc; merge small trailing clusters (knn_graph.h:100-112)
        clusters.sort(key=len, reverse=True)
        buckets: List[np.ndarray] = []
        merged: List[np.ndarray] = []
        merged_size = 0
        while clusters and len(clusters[-1]) < self.MIN_CLUSTER_SIZE:
            c = clusters.pop()
            if merged and merged_size + len(c) > self.MAX_MERGED_CLUSTER_SIZE:
                buckets.append(np.concatenate(merged))
                merged, merged_size = [], 0
            merged.append(c)
            merged_size += len(c)
        if merged:
            buckets.append(np.concatenate(merged))

        for cluster in clusters:
            if depth > self.MAX_DEPTH or (
                depth > self.CONCERNING_DEPTH
                and len(cluster) > self.TOO_SMALL_SHRINKAGE_FRACTION * len(ids)
            ):
                # near-duplicate base case: random split (knn_graph.h:120-130)
                shuffled = rng.permutation(cluster)
                for s in range(0, len(shuffled), self.MAX_CLUSTER_SIZE):
                    buckets.append(shuffled[s : s + self.MAX_CLUSTER_SIZE])
            else:
                buckets.extend(
                    self._sketch(points, cluster, depth + 1, 1, rng)
                )
        return buckets

    # -- bucket brute force ----------------------------------------------------
    def _crunch_buckets(
        self, points: np.ndarray, buckets: List[np.ndarray], num_neighbors: int
    ) -> Graph:
        """Batched all-pairs within buckets + global per-point top-k merge with
        dedup (reference BruteForceBuckets, knn_graph.h:187-250)."""
        n = points.shape[0]
        k = num_neighbors
        # group buckets into power-of-two capacity classes to bound compiles
        groups: dict[int, List[np.ndarray]] = {}
        for b in buckets:
            if len(b) < 2:
                continue
            cap = 1 << max(int(np.ceil(np.log2(len(b)))), 5)
            groups.setdefault(cap, []).append(b)

        src_list: List[np.ndarray] = []
        dst_list: List[np.ndarray] = []
        dist_list: List[np.ndarray] = []
        max_group = 64  # buckets crunched per device dispatch
        for cap, bs in sorted(groups.items()):
            for s in range(0, len(bs), max_group):
                chunk = bs[s : s + max_group]
                nb = len(chunk)
                blocks = np.zeros((nb, cap, points.shape[1]), np.float32)
                sizes = np.zeros(nb, np.int32)
                for j, b in enumerate(chunk):
                    blocks[j, : len(b)] = points[b]
                    sizes[j] = len(b)
                kk = min(k, cap - 1)
                d, li = _crunch_group(
                    jnp.asarray(blocks), jnp.asarray(sizes), kk, self.metric
                )
                d, li = np.asarray(d), np.asarray(li)
                for j, b in enumerate(chunk):
                    sz = len(b)
                    kv = min(kk, sz - 1)
                    src_list.append(np.repeat(b, kv))
                    dst_list.append(b[li[j, :sz, :kv].reshape(-1)])
                    dist_list.append(d[j, :sz, :kv].reshape(-1))

        src = np.concatenate(src_list)
        dst = np.concatenate(dst_list)
        dist = np.concatenate(dist_list)
        # global merge: per point, dedup neighbors, keep k smallest
        # (replaces the reference's per-point spinlock merge, knn_graph.h:221-234)
        order = np.lexsort((dist, dst, src))
        src, dst, dist = src[order], dst[order], dist[order]
        first = np.ones(len(src), dtype=bool)
        first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst, dist = src[first], dst[first], dist[first]
        order = np.lexsort((dist, src))
        src, dst, dist = src[order], dst[order], dist[order]
        starts = np.searchsorted(src, np.arange(n + 1))
        graph = np.full((n, k), -1, dtype=np.int32)
        rank = np.arange(len(src)) - starts[src]
        keep = rank < k
        graph[src[keep], rank[keep]] = dst[keep]
        # fill ragged tails by repeating the closest neighbor; fully isolated
        # points (never in a >=2 bucket) fall back to a non-self neighbor id
        bad = graph < 0
        if bad.any():
            fallback = (np.arange(n, dtype=np.int32) + 1) % max(n, 1)
            first_col = np.where(graph[:, 0] >= 0, graph[:, 0], fallback)
            graph = np.where(bad, first_col[:, None], graph)
        return graph

    def build(self, points: np.ndarray, num_neighbors: int) -> Graph:
        """Reference BuildApproximateNearestNeighborGraph (knn_graph.h:145-162)."""
        points = np.ascontiguousarray(points, dtype=np.float32)
        n = points.shape[0]
        all_ids = np.arange(n, dtype=np.int64)
        buckets: List[np.ndarray] = []
        for rep in range(self.REPETITIONS):
            rng = np.random.default_rng(self.seed + rep)
            buckets.extend(self._sketch(points, all_ids, 0, self.FANOUT, rng))
            if not self.quiet:
                print(f"sketching rep {rep}: {len(buckets)} buckets so far")
        return self._crunch_buckets(points, buckets, num_neighbors)


def symmetrize_to_csr(
    graph: Graph, n: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense [n,k] kNN graph -> symmetrized CSR (indptr, indices, edge_weights).

    Duplicate directed edges collapse with weight = multiplicity (an edge
    confirmed both ways weighs 2), mirroring the union semantics of the
    reference's Symmetrize (knn_graph.h:272-283) while keeping the extra
    signal as an edge weight for the partitioner.
    """
    n = n or graph.shape[0]
    k = graph.shape[1]
    u = np.repeat(np.arange(n, dtype=np.int64), k)
    v = graph.reshape(-1).astype(np.int64)
    valid = (v >= 0) & (v != u)
    u, v = u[valid], v[valid]
    uu = np.concatenate([u, v])
    vv = np.concatenate([v, u])
    key = uu * n + vv
    key, counts = np.unique(key, return_counts=True)
    uu = (key // n).astype(np.int32)
    vv = (key % n).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, uu + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, vv, counts.astype(np.float32)


def graph_recall(approx: Graph, exact: Graph) -> float:
    """Fraction of exact kNN edges recovered (graph_quality_benchmark.cpp:53-66).

    Vectorized membership test: both neighbor lists sorted per row, then a
    searchsorted-style row-wise lookup (no per-node Python loop)."""
    n, k = exact.shape
    ex = np.sort(exact, axis=1)
    # rank of each approx neighbor within its sorted exact row; a hit iff the
    # exact entry at that rank equals it. O(k) column passes, no row loop.
    hits = 0
    for c in range(approx.shape[1]):
        col = approx[:, c : c + 1]
        pos = np.clip((ex < col).sum(axis=1), 0, k - 1)
        hits += int((np.take_along_axis(ex, pos[:, None], axis=1)[:, 0] == col[:, 0]).sum())
    return hits / (n * k)
