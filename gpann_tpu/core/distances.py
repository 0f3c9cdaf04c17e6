"""Batched distance kernels as matrix products.

The reference computes distances one pair at a time with AVX (``src/dist.cpp``).
On the accelerator, *all* distance evaluation is a batched matrix product:

    L2^2(q, x) = |q|^2 + |x|^2 - 2 q.x      (reference sqr_l2_dist, dist.cpp:9-39)
    MIPS(q, x) = 1 - q.x                    (reference mips_distance, dist.cpp:50-52)

The metric is a runtime argument (static under jit) rather than the reference's
compile-time ``MIPS_DISTANCE`` build flag (``CMakeLists.txt:54-59``), so one
binary serves both L2 and inner-product datasets.

``pos_distance`` parity (``dist.cpp:83-88``): for MIPS objectives that must be
non-negative (k-means objective values), shift by +1.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

Metric = str  # "l2" | "mips"

_METRICS = ("l2", "mips")

# Default matmul precision for distance kernels. On the GPU, HIGH (like
# DEFAULT) runs an f32 product in TF32 on the tensor cores: 10 mantissa bits,
# so inputs round at about 2^-11 relative, and |q|^2+|x|^2-2qx loses that
# much of the norms' scale to cancellation. HIGHEST runs full f32. Every
# search path only picks candidates at this precision and rescores them in
# exact f32 (see gpann_tpu/search/ivf.py), so HIGH keeps recall; PERF.md
# records HIGH against HIGHEST after rescore on an H100.
def default_precision():
    return jax.lax.Precision.HIGH


def _check_metric(metric: Metric) -> None:
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {_METRICS}")


def sq_norms(x: jnp.ndarray) -> jnp.ndarray:
    """Row-wise squared norms, shape [n]."""
    return jnp.sum(x * x, axis=-1)


def l2_normalize(x: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Row-normalize to unit L2 norm (reference L2Normalize, dist.cpp:60-67)."""
    return x * jax.lax.rsqrt(jnp.maximum(sq_norms(x), eps))[..., None]


@functools.partial(jax.jit, static_argnames=("metric", "precision"))
def pairwise_distances(
    queries: jnp.ndarray,
    base: jnp.ndarray,
    metric: Metric = "l2",
    base_sq_norms: Optional[jnp.ndarray] = None,
    precision=None,
) -> jnp.ndarray:
    """Dense [m, n] distance matrix between queries [m, d] and base [n, d].

    One matmul plus broadcast adds; replaces the reference's scalar
    ``distance()`` dispatch (``src/dist.cpp:75-81``).

    Byte inputs (u8/i8 bases) are widened to f32 ON DEVICE — the reference
    widens at read time (``points_io.cpp:114-124``); here the host uploads
    raw bytes (4x fewer upload bytes) and the cast runs on the device.
    """
    _check_metric(metric)
    if queries.dtype != jnp.float32:
        queries = queries.astype(jnp.float32)
    if base.dtype != jnp.float32:
        base = base.astype(jnp.float32)
    if precision is None:
        precision = default_precision()
    dots = jnp.dot(
        queries, base.T, preferred_element_type=jnp.float32, precision=precision
    )
    if metric == "mips":
        return 1.0 - dots
    if base_sq_norms is None:
        base_sq_norms = sq_norms(base)
    d = sq_norms(queries)[:, None] + base_sq_norms[None, :] - 2.0 * dots
    return jnp.maximum(d, 0.0)


def pos_distance_offset(metric: Metric) -> float:
    """Additive shift making distances non-negative (dist.cpp:83-88)."""
    return 1.0 if metric == "mips" else 0.0


def _merge_topk(
    vals: jnp.ndarray, idx: jnp.ndarray, new_vals: jnp.ndarray, new_idx: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge two per-row candidate sets, keeping the k smallest values."""
    cat_vals = jnp.concatenate([vals, new_vals], axis=1)
    cat_idx = jnp.concatenate([idx, new_idx], axis=1)
    neg_top, pos = jax.lax.top_k(-cat_vals, k)
    return -neg_top, jnp.take_along_axis(cat_idx, pos, axis=1)


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "block_rows", "precision")
)
def topk_neighbors(
    queries: jnp.ndarray,
    base: jnp.ndarray,
    k: int,
    metric: Metric = "l2",
    block_rows: int = 65536,
    precision=None,
    n_valid=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k nearest neighbors of each query in ``base``.

    Returns ``(dists [m,k], ids [m,k])`` sorted ascending by distance.
    Streams the base set in ``block_rows`` chunks with a running top-k merge,
    so the [m, n] distance matrix is never materialized — the replacement
    for the reference's brute-force loops (``ClosestLeaders`` defs.cpp:87-96,
    ``ComputeGroundTruth`` recall.h:10-39).

    ``n_valid`` (traced scalar, optional): rows ``>= n_valid`` of ``base`` are
    padding — masked to +inf BEFORE selection, so zero-padded blocks (whose
    padding rows would otherwise score ``|q|^2`` under L2 or ``1.0`` under
    MIPS) can never displace real neighbors from the top-k.

    Byte inputs are widened to f32 on device (see pairwise_distances).
    """
    _check_metric(metric)
    if queries.dtype != jnp.float32:
        queries = queries.astype(jnp.float32)
    if base.dtype != jnp.float32:
        base = base.astype(jnp.float32)
    if precision is None:
        precision = default_precision()
    m = queries.shape[0]
    n, d = base.shape
    if n <= block_rows:
        dm = pairwise_distances(queries, base, metric, precision=precision)
        if n_valid is not None:
            dm = jnp.where(jnp.arange(n)[None, :] < n_valid, dm, jnp.inf)
        kk = min(k, n)
        neg, ids = jax.lax.top_k(-dm, kk)
        if kk < k:  # pad (callers use masks / n>=k in practice)
            neg = jnp.pad(neg, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
            ids = jnp.pad(ids, ((0, 0), (0, k - kk)), constant_values=n)
        return -neg, ids

    num_blocks = (n + block_rows - 1) // block_rows
    pad_n = num_blocks * block_rows
    if pad_n != n:
        pad = jnp.full((pad_n - n, d), jnp.inf if metric == "l2" else 0.0, base.dtype)
        base = jnp.concatenate([base, pad], axis=0)
    base_blocks = base.reshape(num_blocks, block_rows, d)
    q_sq = sq_norms(queries) if metric == "l2" else None

    def scan_body(carry, inp):
        vals, idx = carry
        blk, blk_start = inp
        dots = jnp.dot(
            queries, blk.T, preferred_element_type=jnp.float32, precision=precision
        )
        if metric == "mips":
            dm = 1.0 - dots
        else:
            dm = q_sq[:, None] + sq_norms(blk)[None, :] - 2.0 * dots
        # mask padded rows
        limit = n if n_valid is None else n_valid
        valid = (blk_start + jnp.arange(block_rows)) < limit
        dm = jnp.where(valid[None, :], dm, jnp.inf)
        neg, pos = jax.lax.top_k(-dm, k)
        vals, idx = _merge_topk(vals, idx, -neg, pos + blk_start, k)
        return (vals, idx), None

    init = (
        jnp.full((m, k), jnp.inf, jnp.float32),
        jnp.full((m, k), n, jnp.int32),
    )
    starts = jnp.arange(num_blocks, dtype=jnp.int32) * block_rows
    (vals, idx), _ = jax.lax.scan(scan_body, init, (base_blocks, starts))
    if metric == "l2":
        vals = jnp.maximum(vals, 0.0)
    return vals, idx


@functools.partial(jax.jit, static_argnames=("metric", "precision"))
def assign_closest(
    points: jnp.ndarray,
    centers: jnp.ndarray,
    metric: Metric = "l2",
    precision=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-1 assignment: for each point, (distance to, index of) nearest center.

    The k-means assignment kernel (reference kmeans.cpp:12-27) as one matmul +
    row argmin.
    """
    dm = pairwise_distances(points, centers, metric, precision=precision)
    idx = jnp.argmin(dm, axis=1)
    return jnp.take_along_axis(dm, idx[:, None], axis=1)[:, 0], idx


def streaming_topk_neighbors(
    queries,
    base,                     # array-like / np.memmap [n, d], host-resident
    k: int,
    metric: Metric = "l2",
    base_chunk: int = 1 << 21,
    query_block: int = 8192,
    precision=None,
):
    """Exact top-k when the base exceeds device memory.

    Streams host-resident base chunks through the device (one upload each)
    and merges per-chunk top-k on host — the 1B-scale ground-truth/scan path
    (SURVEY.md §5.7: host-RAM offload, blocked aggregation). Returns numpy
    (dists [m,k], ids [m,k]).
    """
    import numpy as _np

    n = base.shape[0]
    m = queries.shape[0]
    best_d = _np.full((m, k), _np.inf, _np.float32)
    best_i = _np.full((m, k), -1, _np.int64)
    for s in range(0, n, base_chunk):
        # keep the source dtype: byte bases upload raw and widen on device
        # (4x fewer upload bytes)
        blk = _np.asarray(base[s : s + base_chunk])
        d, i = chunked_topk_neighbors(
            queries, blk, min(k, len(blk)), metric=metric,
            query_block=query_block, precision=precision,
        )
        if d.shape[1] < k:
            d = _np.pad(d, ((0, 0), (0, k - d.shape[1])),
                        constant_values=_np.inf)
            i = _np.pad(i, ((0, 0), (0, k - i.shape[1])), constant_values=-1)
        cat_d = _np.concatenate([best_d, d], axis=1)
        cat_i = _np.concatenate([best_i, i.astype(_np.int64) + s], axis=1)
        sel = _np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        best_d = _np.take_along_axis(cat_d, sel, axis=1)
        best_i = _np.take_along_axis(cat_i, sel, axis=1)
    return best_d, best_i


def chunked_topk_neighbors(
    queries,
    base,
    k: int,
    metric: Metric = "l2",
    query_block: int = 8192,
    block_rows: int = 65536,
    precision=None,
):
    """Host-side driver: stream queries through ``topk_neighbors`` in blocks.

    For query sets too large to keep the [m, n_block] distance tiles in HBM at
    once. Returns numpy arrays.
    """
    import numpy as np

    base = jnp.asarray(base)
    outs_d, outs_i = [], []
    m = queries.shape[0]
    for s in range(0, m, query_block):
        qb = jnp.asarray(queries[s : s + query_block])
        d, i = topk_neighbors(
            qb, base, k, metric=metric, block_rows=block_rows, precision=precision
        )
        outs_d.append(np.asarray(d))
        outs_i.append(np.asarray(i))
    return np.concatenate(outs_d, axis=0), np.concatenate(outs_i, axis=0)
