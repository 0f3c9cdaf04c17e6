"""Shard-major IVF index: the accelerator in-shard search engine.

Reference parity: the brute-force ``InvertedIndex`` (``src/inverted_index.h``)
is *already* the right GPU design — points re-laid-out contiguously by cluster
plus an id permutation (``inverted_index.h:20-41``); its query is a scan of
the probed buckets into a bounded heap (``inverted_index.h:43-75``). Here the
layout becomes a padded ``[num_shards, capacity, d]`` tensor, and a bucket
scan becomes one ``[m, capacity]`` distance matmul + ``lax.top_k``.

It also subsumes the HNSW-per-shard search bench (``src/shard_searches.cpp``):
an exact scan returns the true in-shard top-k, i.e. it achieves the recall of
HNSW at ``ef -> inf`` for every shard, so the hit-recording semantics
(``dist <= d_k(q)``, ``shard_searches.cpp:80-91``) carry over with the
candidate budget k taking the role of the ef sweep.

Three query paths:

- :meth:`IVFIndex.search_all_shards` — every query against every shard,
  returning per-(shard, query) top-k. This mirrors the reference's
  evaluation semantics exactly (``shard_searches.cpp:21-96`` runs all queries
  through every shard and lets routing decide later which pairs count).
- :meth:`IVFIndex.search_probed` — dense serving path: scan over shards,
  queries not probing the shard masked out. Correct for any probe matrix;
  FLOPs are s-independent (full scan), use for small scale.
- :meth:`IVFIndex.search_probed_grouped` — grouped serving path: queries are
  bucketed by probed shard on host, padded into fixed-size blocks, and only
  probed (query-block, shard) pairs are computed — FLOPs proportional to
  nprobes * shard size, the real production cost.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpann_tpu.core.distances import Metric, sq_norms
from gpann_tpu.core.partition import Clusters


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _exact_rescore(qs, block, scan_d, pos, k: int, metric: Metric):
    """Exact f32 re-ranking of scanned candidates.

    The HIGH-precision matmul scan (TF32 on the GPU) misorders near-ties;
    gathering the top-K candidates and recomputing their distances exactly
    (sum((q-c)^2) / exact dot) restores exact top-k at negligible cost
    (candidate set is [m, K, d] with K ~ 16). Masked (inf) scan entries stay
    masked. Returns (dists [m, k], positions-in-block [m, k])."""
    cand = block[pos]  # [m, K, d]
    if metric == "mips":
        exact = 1.0 - jnp.einsum(
            "md,mkd->mk", qs, cand, precision=jax.lax.Precision.HIGHEST
        )
    else:
        exact = jnp.sum((qs[:, None, :] - cand) ** 2, axis=-1)
    exact = jnp.where(jnp.isfinite(scan_d), exact, jnp.inf)
    neg, sel = jax.lax.top_k(-exact, k)
    return -neg, jnp.take_along_axis(pos, sel, axis=1)


def _scan_k(k: int, cap: int, rescore: bool) -> int:
    """Candidate count for the scan phase (top_k is fast for small k)."""
    return min(max(k, 16) if rescore else k, cap)


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "precision", "rescore")
)
def _scan_all_shards(queries, shard_points, shard_sizes, shard_ids, k: int,
                     metric: Metric, precision=None, rescore: bool = True):
    """[s, cap, d] blocks -> per-shard top-k for all queries.

    Returns (dists [s, m, k], ids [s, m, k]) with global point ids.
    """
    q_sq = sq_norms(queries) if metric == "l2" else None

    def one_shard(block, size, ids):
        dots = jnp.dot(queries, block.T, preferred_element_type=jnp.float32,
                       precision=precision)
        if metric == "mips":
            dm = 1.0 - dots
        else:
            dm = q_sq[:, None] + sq_norms(block)[None, :] - 2.0 * dots
        cap = block.shape[0]
        valid = jnp.arange(cap) < size
        dm = jnp.where(valid[None, :], dm, jnp.inf)
        neg, pos = jax.lax.top_k(-dm, _scan_k(k, cap, rescore))
        if rescore:
            d, pos2 = _exact_rescore(queries, block, -neg, pos, k, metric)
            return d, ids[pos2]
        return -neg[:, :k], ids[pos[:, :k]]

    def body(carry, inp):
        block, size, ids = inp
        d, i = one_shard(block, size, ids)
        return carry, (d, i)

    _, (dists, ids) = jax.lax.scan(
        body, None, (shard_points, shard_sizes, shard_ids)
    )
    if metric == "l2":
        dists = jnp.where(jnp.isfinite(dists), jnp.maximum(dists, 0.0), dists)
    return dists, ids


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "precision", "rescore")
)
def _scan_probed_dense(queries, probes, shard_points, shard_sizes, shard_ids,
                       k: int, metric: Metric, precision=None,
                       rescore: bool = True):
    """Running top-k over shards; query q participates in shard b only if b
    appears in probes[q]. Returns merged (dists [m, k], ids [m, k])."""
    m = queries.shape[0]
    q_sq = sq_norms(queries) if metric == "l2" else None

    def body(carry, inp):
        best_d, best_i = carry
        shard_idx, block, size, ids = inp
        dots = jnp.dot(queries, block.T, preferred_element_type=jnp.float32,
                       precision=precision)
        if metric == "mips":
            dm = 1.0 - dots
        else:
            dm = q_sq[:, None] + sq_norms(block)[None, :] - 2.0 * dots
        cap = block.shape[0]
        valid = jnp.arange(cap) < size
        probing = jnp.any(probes == shard_idx, axis=1)
        dm = jnp.where(valid[None, :] & probing[:, None], dm, jnp.inf)
        neg, pos = jax.lax.top_k(-dm, _scan_k(k, cap, rescore))
        if rescore:
            d, pos2 = _exact_rescore(queries, block, -neg, pos, k, metric)
            i = ids[pos2]
        else:
            d, i = -neg[:, :k], ids[pos[:, :k]]
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, i], axis=1)
        nneg, npos = jax.lax.top_k(-cat_d, k)
        return (-nneg, jnp.take_along_axis(cat_i, npos, axis=1)), None

    init = (jnp.full((m, k), jnp.inf, jnp.float32), jnp.full((m, k), -1, jnp.int32))
    s = shard_points.shape[0]
    (dists, ids), _ = jax.lax.scan(
        body, init,
        (jnp.arange(s, dtype=jnp.int32), shard_points, shard_sizes, shard_ids),
    )
    if metric == "l2":
        dists = jnp.where(jnp.isfinite(dists), jnp.maximum(dists, 0.0), dists)
    return dists, ids


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "precision", "rescore")
)
def _scan_query_blocks(q_blocks, block_shard, shard_points, shard_sizes,
                       shard_ids, k: int, metric: Metric, precision=None,
                       rescore: bool = True):
    """Grouped path: q_blocks [nb, qb, d], block_shard [nb] -> per-block
    top-k within its assigned shard. Shard blocks are gathered from HBM per
    step by XLA (dynamic-slice on the scan input)."""

    def body(carry, inp):
        qs, b = inp
        block = shard_points[b]
        size = shard_sizes[b]
        ids = shard_ids[b]
        dots = jnp.dot(qs, block.T, preferred_element_type=jnp.float32,
                       precision=precision)
        if metric == "mips":
            dm = 1.0 - dots
        else:
            dm = (
                sq_norms(qs)[:, None] + sq_norms(block)[None, :] - 2.0 * dots
            )
        cap = block.shape[0]
        valid = jnp.arange(cap) < size
        dm = jnp.where(valid[None, :], dm, jnp.inf)
        neg, pos = jax.lax.top_k(-dm, _scan_k(k, cap, rescore))
        if rescore:
            d, pos2 = _exact_rescore(qs, block, -neg, pos, k, metric)
            return carry, (d, ids[pos2])
        return carry, (-neg[:, :k], ids[pos[:, :k]])

    _, (dists, ids) = jax.lax.scan(body, None, (q_blocks, block_shard))
    if metric == "l2":
        dists = jnp.where(jnp.isfinite(dists), jnp.maximum(dists, 0.0), dists)
    return dists, ids


class IVFIndex:
    """Shard-major inverted file over a clustering of the base points."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        metric: Metric = "l2",
        pad_multiple: int = 128,
        precision=None,
        rescore: bool = True,
    ) -> None:
        from gpann_tpu.core.distances import default_precision

        self.metric: Metric = metric
        # HIGH-precision scan + exact candidate rescore = exact top-k at
        # reduced-precision speed (see _exact_rescore)
        self.precision = default_precision() if precision is None else precision
        self.rescore = rescore
        self.num_shards = len(clusters)
        self.dim = points.shape[1]
        sizes = np.asarray([len(c) for c in clusters], dtype=np.int32)
        cap = _round_up(max(int(sizes.max()), 1), pad_multiple)
        self.capacity = cap
        blocks = np.zeros((self.num_shards, cap, self.dim), dtype=np.float32)
        ids = np.full((self.num_shards, cap), -1, dtype=np.int32)
        for b, members in enumerate(clusters):
            members = np.asarray(members, dtype=np.int64)
            blocks[b, : len(members)] = points[members]
            ids[b, : len(members)] = members
        self.shard_points = jnp.asarray(blocks)
        self.shard_sizes = jnp.asarray(sizes)
        self.shard_ids = jnp.asarray(ids)
        self.sizes_np = sizes
        # overlap detection: dedup across probes is only needed when some
        # point belongs to more than one cluster
        all_ids = (
            np.concatenate([np.asarray(c) for c in clusters if len(c)])
            if any(len(c) for c in clusters)
            else np.empty(0, np.int32)
        )
        self.overlapping = len(np.unique(all_ids)) < len(all_ids)

    # -- evaluation path ----------------------------------------------------
    def search_all_shards(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-(shard, query) exact top-k: (dists [s, m, k], ids [s, m, k])."""
        d, i = _scan_all_shards(
            jnp.asarray(queries, jnp.float32),
            self.shard_points,
            self.shard_sizes,
            self.shard_ids,
            k,
            self.metric,
            self.precision,
            self.rescore,
        )
        return np.asarray(d), np.asarray(i)

    # -- serving paths -------------------------------------------------------
    def search_probed(
        self, queries: np.ndarray, probes: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense path. ``probes`` [m, nprobes] shard ids (use -1 padding)."""
        d, i = _scan_probed_dense(
            jnp.asarray(queries, jnp.float32),
            jnp.asarray(probes, jnp.int32),
            self.shard_points,
            self.shard_sizes,
            self.shard_ids,
            k,
            self.metric,
            self.precision,
            self.rescore,
        )
        return np.asarray(d), np.asarray(i)

    def search_probed_grouped(
        self,
        queries: np.ndarray,
        probes: np.ndarray,
        k: int,
        query_block: int = 256,
        dedup: Optional[bool] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Grouped path: compute only probed (query, shard) pairs.

        Bucketing and the final merge are fully vectorized: the (query, shard)
        probe pairs are sorted by shard, padded into fixed [query_block]
        blocks, scanned in one jitted call, and scattered back into a
        [m, nprobes*k] candidate table merged by one sort. Id dedup across
        probes (only possible with overlapping clusters) runs only when the
        index was built from an overlapping clustering.
        """
        queries = np.asarray(queries, dtype=np.float32)
        m, nprobes = probes.shape
        dedup = self.overlapping if dedup is None else dedup

        # flatten (query, shard) pairs, drop -1 pads, sort by shard
        flat_q = np.repeat(np.arange(m, dtype=np.int64), nprobes)
        flat_slot = np.tile(np.arange(nprobes, dtype=np.int64), m)
        flat_b = probes.reshape(-1).astype(np.int64)
        keep = flat_b >= 0
        flat_q, flat_slot, flat_b = flat_q[keep], flat_slot[keep], flat_b[keep]
        order = np.argsort(flat_b, kind="stable")
        flat_q, flat_slot, flat_b = flat_q[order], flat_slot[order], flat_b[order]
        if len(flat_q) == 0:
            return (
                np.full((m, k), np.inf, np.float32),
                np.full((m, k), -1, np.int32),
            )

        # pad each shard's run to a multiple of query_block (vectorized):
        counts = np.bincount(flat_b, minlength=self.num_shards)
        padded_counts = -(-counts // query_block) * query_block
        total = int(padded_counts.sum())
        starts = np.concatenate([[0], np.cumsum(padded_counts)])[:-1]
        run_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        # position of each pair within the padded layout
        pos = starts[flat_b] + (np.arange(len(flat_b)) - run_starts[flat_b])
        pair_q = np.zeros(total, dtype=np.int64)  # padding points at query 0
        pair_q[pos] = flat_q
        valid = np.zeros(total, dtype=bool)
        valid[pos] = True

        nb = total // query_block
        q_blocks = queries[pair_q].reshape(nb, query_block, -1)
        block_shard = np.repeat(
            np.arange(self.num_shards, dtype=np.int32),
            (padded_counts // query_block),
        )
        d, i = _scan_query_blocks(
            jnp.asarray(q_blocks),
            jnp.asarray(block_shard),
            self.shard_points,
            self.shard_sizes,
            self.shard_ids,
            k,
            self.metric,
            self.precision,
            self.rescore,
        )
        d = np.asarray(d).reshape(total, k)
        i = np.asarray(i).reshape(total, k)

        # scatter into the per-query candidate table (one fancy index)
        out_d = np.full((m, nprobes, k), np.inf, dtype=np.float32)
        out_i = np.full((m, nprobes, k), -1, dtype=np.int32)
        out_d[flat_q, flat_slot] = d[pos]
        out_i[flat_q, flat_slot] = i[pos]
        out_d = out_d.reshape(m, nprobes * k)
        out_i = out_i.reshape(m, nprobes * k)
        if dedup:
            # mask duplicate ids (overlapping shards may return one point twice)
            sort = np.argsort(out_i, axis=1, kind="stable")
            sorted_i = np.take_along_axis(out_i, sort, axis=1)
            dup_sorted = np.zeros_like(sorted_i, dtype=bool)
            dup_sorted[:, 1:] = (sorted_i[:, 1:] == sorted_i[:, :-1]) & (
                sorted_i[:, 1:] >= 0
            )
            dup = np.zeros_like(dup_sorted)
            np.put_along_axis(dup, sort, dup_sorted, axis=1)
            # keep the closest occurrence: duplicates share distance; masking
            # all-but-one by sorted order is id-stable
            out_d = np.where(dup, np.inf, out_d)
        sel = np.argsort(out_d, axis=1, kind="stable")[:, :k]
        return (
            np.take_along_axis(out_d, sel, axis=1),
            np.take_along_axis(out_i, sel, axis=1),
        )


def hits_per_shard(
    shard_dists: np.ndarray, kth_dist: np.ndarray, eps: float = 1e-5,
    rel_eps: float = 1e-4,
) -> np.ndarray:
    """Hit counts per (shard, query): returned points with dist <= d_k(q)
    (reference hit recording, shard_searches.cpp:80-91). The relative term
    absorbs f32 summation-order noise between GT and search kernels."""
    thresh = kth_dist[None, :, None] * (1.0 + rel_eps) + eps
    return (shard_dists <= thresh).sum(axis=2).astype(np.int32)


def merge_shard_topk(
    shard_dists: np.ndarray,
    shard_ids: np.ndarray,
    probe_order: np.ndarray,
    nprobes: int,
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard top-k results along each query's probe order.

    ``shard_dists/ids`` are [s, m, k] from :meth:`search_all_shards`;
    ``probe_order`` is [m, s] shard ids by priority. Deduplicates point ids
    (overlapping shards may return the same point, mirroring the dedup in
    small_scale_queries.cpp:158-165). Returns ([m,k] dists, [m,k] ids).
    """
    s, m, kk = shard_dists.shape
    probed = probe_order[:, :nprobes]  # [m, nprobes]
    qidx = np.arange(m)[:, None]
    cand_d = shard_dists[probed, qidx, :].reshape(m, -1)
    cand_i = shard_ids[probed, qidx, :].reshape(m, -1)
    # dedup ids keeping the closest occurrence, fully vectorized (100k-query
    # sets must stay tractable on the single-core host): sort each row by
    # (id, dist) via two stable argsorts, mask adjacent duplicates, scatter
    # the mask back, then take the k smallest surviving distances
    o1 = np.argsort(cand_d, axis=1, kind="stable")
    i1 = np.take_along_axis(cand_i, o1, axis=1)
    o2 = np.argsort(i1, axis=1, kind="stable")
    ordix = np.take_along_axis(o1, o2, axis=1)
    sids = np.take_along_axis(cand_i, ordix, axis=1)
    dup_sorted = np.zeros_like(sids, dtype=bool)
    dup_sorted[:, 1:] = (sids[:, 1:] == sids[:, :-1]) & (sids[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, ordix, dup_sorted, axis=1)
    cand_d = np.where(dup | (cand_i < 0), np.inf, cand_d)
    order = np.argsort(cand_d, axis=1, kind="stable")[:, :k]
    out_d = np.take_along_axis(cand_d, order, axis=1).astype(np.float32)
    sel_i = np.take_along_axis(cand_i, order, axis=1)
    out_i = np.where(np.isfinite(out_d), sel_i, -1).astype(np.int32)
    out_d = np.where(np.isfinite(out_d), out_d, np.inf).astype(np.float32)
    return out_d, out_i
