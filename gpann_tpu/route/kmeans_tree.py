"""K-means-tree router: budgeted hierarchical k-means per shard.

Reference parity: ``src/kmeans_tree_router.{h,cpp}``.

- ``Train`` (``kmeans_tree_router.cpp:9-33``): per shard, a hierarchical
  k-means tree under a global *size budget* split across shards proportional
  to cluster sizes; recursion at ``:35-78`` with at most ``num_centroids``
  children per node, children below ``min_cluster_size`` or with no remaining
  budget become leaves.
- ``ExtractPoints`` (``:174-201``): flatten all centroids + shard labels into
  a routing point set (this is what the reference trains its HNSW router on).
- ``Query``/``FrequencyQuery`` (``:93-172``): the reference walks the trees
  best-first under a distance-computation budget. Redesign: the walk is
  replaced by an exact batched scan of the *extracted* centroid set (the
  reference's own HNSW router demonstrates extracted-points routing matches
  tree routing); ranking rules are shared with :class:`FlatRouter`.

Host orchestrates the recursion (irregular control flow); every node's
k-means runs on device. Node point sets are padded to power-of-two buckets
with zero-weight padding so XLA compiles O(log n) shapes, not one per node.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpann_tpu.cluster.kmeans import kmeans
from gpann_tpu.core.distances import Metric
from gpann_tpu.core.partition import Clusters
from gpann_tpu.route.flat import FlatRouter


@functools.partial(
    jax.jit, static_argnames=("t", "num_shards", "metric", "budget")
)
def _budgeted_votes_kernel(queries, points, labels, group_of, top_index,
                           group_sizes, *, t: int, num_shards: int,
                           metric: Metric, budget: int):
    """Capped-descent vote fold, one program: top-level scan -> greedy
    subtree admission under the distance-comp budget -> top-t votes masked
    to admitted subtrees (kmeans_tree_router.cpp:93-130 semantics)."""
    from gpann_tpu.core.distances import pairwise_distances, topk_neighbors

    m = queries.shape[0]
    g = top_index.shape[0]
    tops = points[top_index]
    dm_top = pairwise_distances(queries, tops, metric)
    order = jnp.argsort(dm_top, axis=1)
    costs = group_sizes[order]                       # [m, g]
    cum = jnp.cumsum(costs, axis=1)
    remaining = max(budget - g, 0)
    # admit whole subtrees in top-centroid distance order while they fit;
    # always admit at least the nearest subtree
    sel_sorted = cum <= jnp.maximum(remaining, cum[:, :1])
    row = jnp.arange(m)[:, None]
    sel = jnp.zeros((m, g), bool).at[row, order].set(sel_sorted)
    calcs = g + jnp.where(sel_sorted, costs, 0).sum(axis=1)
    dists, ids = topk_neighbors(queries, points, t, metric=metric)
    keep = sel[row, group_of[ids]]
    vd = jnp.where(keep, dists, jnp.inf)
    vs = jnp.where(keep, labels[ids], num_shards)    # dummy slot for dropped
    min_d = jnp.full((m, num_shards + 1), jnp.inf).at[row, vs].min(vd)
    freq = jnp.zeros((m, num_shards + 1), jnp.int32).at[row, vs].add(
        keep.astype(jnp.int32)
    )
    return min_d[:, :num_shards], freq[:, :num_shards], calcs


@dataclass
class KMeansTreeRouterOptions:
    """Defaults match reference ``kmeans_tree_router.h:6-11`` exactly
    (num_centroids=64, min_cluster_size=250, budget=50000,
    search_budget=50000). ``search_budget`` caps the distance comps of
    :meth:`KMeansTreeRouter.query_budgeted` (the analog of the reference's
    best-first PQ walk budget); the plain :meth:`KMeansTreeRouter.query`
    scans every extracted centroid (the budget -> infinity limit)."""

    num_centroids: int = 64
    min_cluster_size: int = 250
    budget: int = 50_000
    search_budget: int = 50_000


def _bucket_pad(points: np.ndarray, min_size: int = 256) -> np.ndarray:
    """Pad rows up to the next power-of-two bucket (zero rows, masked by
    weights) so repeated node k-means reuses compiled shapes."""
    n = points.shape[0]
    target = max(min_size, 1 << (n - 1).bit_length())
    if target == n:
        return points
    return np.concatenate(
        [points, np.zeros((target - n, points.shape[1]), points.dtype)]
    )


class KMeansTreeRouter:
    """Budgeted hierarchical k-means router over a clustering."""

    def __init__(self, metric: Metric = "l2") -> None:
        self.metric: Metric = metric
        self.points: Optional[np.ndarray] = None  # extracted centroids [R, d]
        self.labels: Optional[np.ndarray] = None  # shard ids [R]
        self._flat: Optional[FlatRouter] = None
        self.num_shards = 0

    # -- training -------------------------------------------------------------
    def train(
        self,
        points: np.ndarray,
        clusters: Clusters,
        options: KMeansTreeRouterOptions = KMeansTreeRouterOptions(),
        seed: int = 555,
    ) -> "KMeansTreeRouter":
        points = np.ascontiguousarray(points, dtype=np.float32)
        self.num_shards = len(clusters)
        n_total = sum(len(c) for c in clusters)
        all_centroids: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        all_groups: List[np.ndarray] = []
        group_offset = 0
        for shard, members in enumerate(clusters):
            members = np.asarray(members, dtype=np.int64)
            if len(members) == 0:
                continue
            # budget split proportional to cluster size (kmeans_tree_router.cpp:20-27)
            budget_i = max(
                1, int(round(options.budget * len(members) / max(n_total, 1)))
            )
            cents, groups = self._train_shard(
                points[members], budget_i, options, seed + shard
            )
            all_centroids.append(cents)
            all_labels.append(np.full(len(cents), shard, dtype=np.int32))
            all_groups.append(groups + group_offset)
            group_offset += int(groups.max()) + 1 if len(groups) else 0
        self.points = np.concatenate(all_centroids, axis=0)
        self.labels = np.concatenate(all_labels, axis=0)
        # subtree bookkeeping for budgeted queries: group_of[i] = top-level
        # subtree of extracted centroid i; top_index[g] = centroid index of
        # subtree g's top-level centroid (the first centroid emitted with
        # that group id — worklist order emits each top before its subtree)
        self.group_of = np.concatenate(all_groups)
        num_groups = group_offset
        first = np.full(num_groups, -1, np.int64)
        rev = np.arange(len(self.group_of))[::-1]
        first[self.group_of[rev]] = rev  # first occurrence of each group id
        self.top_index = first
        assert (self.top_index >= 0).all()
        self._flat = FlatRouter(
            self.points, self.labels, num_shards=self.num_shards, metric=self.metric
        )
        self.search_budget = options.search_budget
        return self

    def _train_shard(
        self,
        pts: np.ndarray,
        budget: int,
        options: KMeansTreeRouterOptions,
        seed: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-orchestrated recursion (kmeans_tree_router.cpp:35-78) via an
        explicit worklist; returns (extracted centroids, top-level subtree id
        per centroid) for this shard. Subtree ids are local (0-based)."""
        out: List[np.ndarray] = []
        out_groups: List[np.ndarray] = []
        next_group = 0
        # (points of node, remaining budget, seed, subtree id or None=root)
        work: List[Tuple[np.ndarray, int, int, Optional[int]]] = [
            (pts, budget, seed, None)
        ]
        while work:
            node_pts, node_budget, node_seed, group = work.pop()
            if node_budget <= 0 or len(node_pts) <= 1:
                continue
            k = int(min(options.num_centroids, node_budget, len(node_pts)))
            padded = _bucket_pad(node_pts)
            weights = np.zeros(len(padded), np.float32)
            weights[: len(node_pts)] = 1.0
            # k varies per node (budget splits); pad the centroid count to
            # one bucket so the whole tree compiles O(log n) programs, not
            # one per distinct (bucket, k) pair
            cents, assign = kmeans(
                padded, k=k, metric=self.metric, seed=node_seed,
                weights=weights, k_pad_to=options.num_centroids,
            )
            assign = assign[: len(node_pts)]
            sizes = np.bincount(assign, minlength=k)
            live = sizes > 0
            cents = cents[live]
            out.append(cents.astype(np.float32))
            if group is None:
                # each top-level centroid starts its own subtree
                child_groups = np.arange(next_group, next_group + len(cents))
                next_group += len(cents)
            else:
                child_groups = np.full(len(cents), group, np.int64)
            out_groups.append(child_groups.astype(np.int64))
            remaining = node_budget - len(cents)
            if remaining <= 0:
                continue
            # children get budget proportional to size; below min_cluster_size
            # they stay leaves (kmeans_tree_router.cpp:58-74)
            total = int(sizes.sum())
            child_ids = np.nonzero(live)[0]
            for ci, c in enumerate(child_ids):
                if sizes[c] < options.min_cluster_size:
                    continue
                child_budget = int(round(remaining * sizes[c] / max(total, 1)))
                if child_budget <= 0:
                    continue
                work.append(
                    (node_pts[assign == c], child_budget,
                     node_seed * 31 + ci + 1, int(child_groups[ci]))
                )
        if not out:
            # degenerate: single representative (mean)
            return (pts.mean(axis=0, keepdims=True).astype(np.float32),
                    np.zeros(1, np.int64))
        return np.concatenate(out, axis=0), np.concatenate(out_groups)

    # -- extraction + queries --------------------------------------------------
    def extract_points(self) -> Tuple[np.ndarray, np.ndarray]:
        """(routing points, shard labels) — reference ExtractPoints
        (kmeans_tree_router.cpp:174-201)."""
        if self.points is None:
            raise RuntimeError("router not trained")
        return self.points, self.labels

    @property
    def flat(self) -> FlatRouter:
        if self._flat is None:
            raise RuntimeError("router not trained")
        return self._flat

    def query(self, queries: np.ndarray, search_budget: int = 5_000) -> np.ndarray:
        """Probe order [m, s]: shards by min extracted-centroid distance
        (the budget->exact limit of reference Query, kmeans_tree_router.cpp:93-130).
        ``search_budget`` caps the number of centroids scanned per query via
        top-T truncation for parity with the reference's budget semantics."""
        t = int(min(search_budget, len(self.flat)))
        min_d, _ = self.flat.query_votes(queries, t)
        from gpann_tpu.route.flat import rank_min_dist

        return rank_min_dist(min_d)

    def frequency_query(
        self, queries: np.ndarray, num_voting_neighbors: int = 120
    ) -> np.ndarray:
        """Probe order by centroid vote frequency (FrequencyQuery,
        kmeans_tree_router.cpp:132-172)."""
        min_d, freq = self.flat.query_votes(queries, num_voting_neighbors)
        from gpann_tpu.route.flat import rank_frequency

        return rank_frequency(freq, min_d)

    # -- budgeted tree-walk analog ---------------------------------------------
    def budgeted_votes(
        self, queries: np.ndarray, search_budget: int,
        num_voting_neighbors: int = 500,
    ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Capped-descent votes: (min_d [m,s], freq [m,s], mean distance
        comps per query).

        The reference's ``Query`` walks all shards' trees best-first and
        stops after ``search_budget`` distance computations
        (``kmeans_tree_router.cpp:93-130``). Redesign with identical
        visibility semantics: per query, scan every TOP-LEVEL centroid (one
        per subtree), admit whole subtrees in increasing top-centroid
        distance while the running centroid count fits the budget, and let
        only admitted subtrees' centroids vote. Smaller budgets see fewer
        subtrees -> coarser votes, restoring the routing-cost-vs-quality
        axis the reference sweeps; ``distance_calcs`` accounts
        |top centroids| + admitted subtree sizes exactly.
        """
        if not hasattr(self, "group_of"):
            raise RuntimeError("router not trained")
        g = len(self.top_index)
        sizes = np.bincount(self.group_of, minlength=g).astype(np.int32)
        t = int(min(num_voting_neighbors, len(self.flat)))
        min_d, freq, calcs = _budgeted_votes_kernel(
            jnp.asarray(np.asarray(queries, np.float32)),
            self.flat.points, self.flat.labels,
            jnp.asarray(self.group_of.astype(np.int32)),
            jnp.asarray(self.top_index.astype(np.int32)),
            jnp.asarray(sizes),
            t=t, num_shards=self.num_shards,
            metric=self.metric, budget=int(search_budget),
        )
        return (np.asarray(min_d), np.asarray(freq),
                float(np.asarray(calcs).mean()))

    def query_budgeted(
        self, queries: np.ndarray, search_budget: Optional[int] = None
    ) -> np.ndarray:
        """Budget-capped probe order by min admitted-centroid distance —
        the reference Query's semantics (kmeans_tree_router.cpp:93-130)."""
        from gpann_tpu.route.flat import rank_min_dist

        budget = self.search_budget if search_budget is None else search_budget
        min_d, _, _ = self.budgeted_votes(queries, budget)
        return rank_min_dist(min_d)

    def frequency_query_budgeted(
        self, queries: np.ndarray, num_voting_neighbors: int = 120,
        search_budget: Optional[int] = None,
    ) -> np.ndarray:
        """Budget-capped frequency probe order (FrequencyQuery,
        kmeans_tree_router.cpp:132-172: same walk, vote fold over the top
        ``num_voting_neighbors`` admitted centroids)."""
        from gpann_tpu.route.flat import rank_frequency

        budget = self.search_budget if search_budget is None else search_budget
        min_d, freq, _ = self.budgeted_votes(
            queries, budget, num_voting_neighbors=num_voting_neighbors
        )
        return rank_frequency(freq, min_d)
