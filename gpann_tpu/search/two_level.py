"""Two-level sharded search: the ef-sweep-equivalent in-shard knob.

The reference sweeps HNSW ``ef_search`` in {50..500} per shard
(``shard_searches.cpp:13``) to trade in-shard work against recall. An exact
matmul scan has no such knob — it always achieves ef->inf recall at O(shard)
FLOPs. The accelerator knob (SURVEY.md §7, hard part 4) is **IVF inside the
shard**: each shard is balanced-k-means'd into sub-clusters of
~``target_sub_size`` points; a query probing a shard scans only its
``sub_nprobe`` closest sub-clusters. ``sub_nprobe`` sweeps coverage from
~1/n_sub of the shard to the full (exact) shard — the same recall/work curve
role as ``ef_search``.

Implementation: the sub-clusters of ALL shards form one fine-grained
:class:`~gpann_tpu.search.ivf.IVFIndex`; ``shard_of_sub`` maps sub-cluster ->
shard; per-query sub-probe lists are derived from (shard probe order x
sub-centroid ranking). All search paths (dense / grouped / all-shards-eval)
reuse the IVF kernels unchanged.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gpann_tpu.cluster.kmeans import balanced_kmeans
from gpann_tpu.core.distances import Metric
from gpann_tpu.core.partition import Clusters
from gpann_tpu.search.ivf import IVFIndex


class TwoLevelIVF:
    """Shard -> sub-cluster hierarchy with a sub_nprobe search budget."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        metric: Metric = "l2",
        target_sub_size: int = 4096,
        sub_eps: float = 0.3,
        seed: int = 555,
        precision=None,
        rescore: bool = True,
    ) -> None:
        self.metric: Metric = metric
        self.num_shards = len(clusters)
        sub_clusters: List[np.ndarray] = []
        shard_of_sub: List[int] = []
        sub_centroids: List[np.ndarray] = []
        for b, members in enumerate(clusters):
            members = np.asarray(members, np.int64)
            if len(members) == 0:
                continue
            n_sub = max(1, int(np.ceil(len(members) / target_sub_size)))
            if n_sub == 1:
                assign = np.zeros(len(members), np.int32)
                cents = points[members].mean(axis=0, keepdims=True)
            else:
                cents, assign = balanced_kmeans(
                    points[members], k=n_sub, eps=sub_eps, metric=metric,
                    seed=seed + b, max_rounds=30,
                )
            for c in range(n_sub):
                sub = members[assign == c]
                if len(sub) == 0:
                    continue
                sub_clusters.append(sub.astype(np.int32))
                shard_of_sub.append(b)
                sub_centroids.append(points[sub].mean(axis=0))
        self.sub_clusters = sub_clusters
        self.shard_of_sub = np.asarray(shard_of_sub, np.int32)
        self.sub_centroids = np.stack(sub_centroids).astype(np.float32)
        if metric == "mips":
            norms = np.sqrt(np.maximum((self.sub_centroids ** 2).sum(1), 1e-12))
            self.sub_centroids = self.sub_centroids / norms[:, None]
        self.num_subs = len(sub_clusters)
        self.max_subs_per_shard = int(
            np.bincount(self.shard_of_sub, minlength=self.num_shards).max()
        )
        self.ivf = IVFIndex(points, sub_clusters, metric=metric,
                            precision=precision, rescore=rescore)

    # -- probe derivation ------------------------------------------------------
    def sub_probes(
        self, queries: np.ndarray, shard_probes: np.ndarray, sub_nprobe: int
    ) -> np.ndarray:
        """[m, nprobes*sub_nprobe] sub-cluster ids: for each probed shard, the
        query's ``sub_nprobe`` closest sub-centroids of that shard (-1 pad)."""
        m, nprobes = shard_probes.shape
        # rank all sub-centroids per query (tiny matmul: num_subs is small)
        import jax.numpy as jnp
        from gpann_tpu.core.distances import pairwise_distances

        dm = np.asarray(
            pairwise_distances(
                jnp.asarray(queries, jnp.float32), jnp.asarray(self.sub_centroids),
                self.metric,
            )
        )
        out = np.full((m, nprobes * sub_nprobe), -1, np.int32)
        # vectorized per probe slot: mask sub-centroid distances to the
        # probed shard's subs, partial-sort the sub_nprobe closest (no
        # per-(slot, shard) Python loop — 100k-query sets stay tractable)
        take = min(sub_nprobe, self.num_subs)
        for j in range(nprobes):
            shard = shard_probes[:, j]
            mask = self.shard_of_sub[None, :] == shard[:, None]
            dmj = np.where(mask, dm, np.inf)
            part = np.argpartition(dmj, take - 1, axis=1)[:, :take]
            pd = np.take_along_axis(dmj, part, axis=1)
            order = np.argsort(pd, axis=1, kind="stable")
            sel = np.take_along_axis(part, order, axis=1)
            sd = np.take_along_axis(pd, order, axis=1)
            sel = np.where(np.isfinite(sd), sel, -1).astype(np.int32)
            out[:, j * sub_nprobe : j * sub_nprobe + take] = sel
        return out

    # -- serving ----------------------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        shard_probes: np.ndarray,
        k: int,
        sub_nprobe: int,
        grouped: bool = True,
        query_block: int = 256,
    ) -> Tuple[np.ndarray, np.ndarray]:
        sp = self.sub_probes(queries, shard_probes, sub_nprobe)
        if grouped:
            return self.ivf.search_probed_grouped(queries, sp, k, query_block)
        return self.ivf.search_probed(queries, sp, k)

    # -- evaluation: per-(shard, query) results at a given sub_nprobe -----------
    def search_all_shards(
        self, queries: np.ndarray, k: int, sub_nprobe: int,
        query_block: int = 256,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[s, m, k] per-shard results where each query probes its
        ``sub_nprobe`` best sub-clusters per shard — the ef-sweep analog of
        the reference's all-(shard, query) measurement
        (shard_searches.cpp:21-96)."""
        m = queries.shape[0]
        out_d = np.full((self.num_shards, m, k), np.inf, np.float32)
        out_i = np.full((self.num_shards, m, k), -1, np.int32)
        for b in range(self.num_shards):
            probes = np.full((m, 1), b, np.int32)
            d, i = self.search(queries, probes, k, sub_nprobe,
                               grouped=True, query_block=query_block)
            out_d[b], out_i[b] = d, i
        return out_d, out_i
