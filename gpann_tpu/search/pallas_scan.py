"""Fused distance scan for the GPU: TF32 matmul + per-bin top-2 epilogue.

The plain XLA scan (``serve.py``'s exact path) writes the f32 ``[qb, cap]``
distance tile to device memory and reads it back for ``lax.top_k``. This
Pallas kernel (Triton route) reduces every distance tile in registers to
per-bin (min1, argmin1, min2, argmin2), so device memory sees only
``[m, 2 * cap / BIN]`` summaries. Top-k then runs at bin granularity and the
winning candidates get an exact f32 rescore. A true neighbor is lost only
when three or more of the true top-k share one bin (birthday statistics over
``cap / BIN`` bins; the candidate oversample absorbs stragglers).

Bin layout. Program ``(b, j, i)`` scans base tile ``j`` (``TILE = BIN *
WIDTH`` rows) of probe block ``b`` for query tile ``i``. It walks the tile in
``BIN`` steps of ``WIDTH`` consecutive rows; column ``w`` of every step feeds
bin ``j * WIDTH + w``. So bin ``g = j * WIDTH + w`` holds the ``BIN`` rows
``j * TILE + c * WIDTH + w`` (``c < BIN``): a strided set, which keeps the
top-2 update elementwise across the ``[tq, WIDTH]`` tile. Programs carry
nothing between them and may run in any order.

Precision. ``pl.dot`` on f32 operands runs in TF32 here (10 mantissa bits,
input rounding about 2^-11 relative). Only the candidate set comes from it;
the exact f32 rescore orders the survivors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpann_tpu.core.distances import Metric

# Block sizes tuned on an H100 at the serving shapes (PERF.md): 128-row query
# tiles with 8 warps were fastest; 64-row tiles ran 1.3x slower, and 128-row
# tiles with 4 warps 3.3x slower. 2-4 pipeline stages were within noise.
BIN = 128                # base rows per bin
WIDTH = 64               # bins per program = rows per inner step
TILE = BIN * WIDTH       # base rows per program
TQ = 128                 # query rows per program
NUM_WARPS = 8
NUM_STAGES = 3
LANE = 128               # feature padding: Triton tensors are powers of two


def _bintop2_kernel(q_ref, off_ref, size_ref, base_ref, mn1_ref, am1_ref,
                    mn2_ref, am2_ref, *, metric: str):
    """One (probe block, base tile, query tile) program.

    ``off_ref``/``size_ref`` hold this block's first row in the flat base and
    its live row count. Steps past the live rows are not run, so a padding
    block (size 0) reads no base rows and emits +inf summaries.
    """
    j = pl.program_id(1)
    size = size_ref[0]
    row0 = off_ref[0] + j * TILE
    live = size - j * TILE
    steps = jnp.minimum(jnp.maximum((live + WIDTH - 1) // WIDTH, 0), BIN)
    q = q_ref[...]
    tq = q.shape[0]
    if metric != "mips":
        qsq = jnp.sum(q * q, axis=1)[:, None]
    cols = jnp.arange(WIDTH, dtype=jnp.int32)

    def body(c, carry):
        m1, a1, m2, a2 = carry
        b = base_ref[pl.ds(row0 + c * WIDTH, WIDTH), :]
        # f32 operands at HIGH precision: TF32 tensor-core product
        dots = pl.dot(q, b, trans_b=True, precision=jax.lax.Precision.HIGH)
        if metric == "mips":
            d = 1.0 - dots
        else:
            d = qsq + jnp.sum(b * b, axis=1)[None, :] - 2.0 * dots
        d = jnp.where((c * WIDTH + cols < live)[None, :], d, jnp.inf)
        lt1 = d < m1
        lt2 = d < m2
        m2 = jnp.where(lt1, m1, jnp.where(lt2, d, m2))
        a2 = jnp.where(lt1, a1, jnp.where(lt2, c, a2))
        m1 = jnp.where(lt1, d, m1)
        a1 = jnp.where(lt1, c, a1)
        return m1, a1, m2, a2

    inf = jnp.full((tq, WIDTH), jnp.inf, jnp.float32)
    zero = jnp.zeros((tq, WIDTH), jnp.int32)
    m1, a1, m2, a2 = jax.lax.fori_loop(0, steps, body, (inf, zero, inf, zero))
    first = j * TILE + cols[None, :]
    mn1_ref[...] = m1
    am1_ref[...] = first + a1 * WIDTH
    mn2_ref[...] = m2
    am2_ref[...] = first + a2 * WIDTH


def _pad_cols(x: jnp.ndarray, d: int) -> jnp.ndarray:
    """Zero feature columns up to ``d``; they change no distance."""
    return x if x.shape[1] == d else jnp.pad(x, ((0, 0), (0, d - x.shape[1])))


def padded_dim(d: int) -> int:
    """Feature width the kernel scans: ``d`` rounded up to ``LANE``."""
    return -(-d // LANE) * LANE


@functools.partial(jax.jit,
                   static_argnames=("metric", "qb", "cap", "tq", "interpret"))
def bin_top2_blocks(
    queries_blocks: jnp.ndarray,   # [nb*qb, d] block-major query rows
    base_flat: jnp.ndarray,        # [R, d] flat base
    row_off: jnp.ndarray,          # [nb] int32 first base row of each window
    sizes: jnp.ndarray,            # [nb] int32 live rows per window (0=skip)
    metric: Metric = "l2",
    qb: int = TQ,
    cap: int = TILE,
    tq: int = TQ,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-bin top-2 of block ``b``'s ``qb`` query rows against base rows
    ``[row_off[b], row_off[b] + cap)`` (live prefix ``sizes[b]``).

    Returns ``(mins [nb*qb, 2L], local row ids [nb*qb, 2L])`` with
    ``L = cap / BIN`` and the two per-bin entries laid out as
    ``[all min1 | all min2]``. Every window must lie inside ``base_flat``.
    """
    nb = row_off.shape[0]
    total = queries_blocks.shape[0]
    if total != nb * qb:
        raise ValueError(f"{total} query rows for {nb} blocks of {qb}")
    if qb % tq or tq < 16 or tq & (tq - 1):
        raise ValueError(f"tq={tq} must be a power of two >= 16 dividing "
                         f"qb={qb}")
    if cap % TILE:
        raise ValueError(f"cap={cap} must be a multiple of TILE={TILE}")
    d = padded_dim(max(base_flat.shape[1], queries_blocks.shape[1]))
    if base_flat.shape[0] * d >= 2**31:
        raise ValueError("base too large for 32-bit element offsets")
    base_flat = _pad_cols(base_flat, d)
    queries_blocks = _pad_cols(queries_blocks, d)
    L = cap // BIN
    rpb = qb // tq
    grid = (nb, cap // TILE, rpb)   # query tiles innermost: L2 reuse of base
    out_spec = pl.BlockSpec((tq, WIDTH), lambda b, j, i: (b * rpb + i, j))
    mn1, am1, mn2, am2 = pl.pallas_call(
        functools.partial(_bintop2_kernel, metric=metric),
        grid=grid,
        in_specs=[
            pl.BlockSpec((tq, d), lambda b, j, i: (b * rpb + i, 0)),
            pl.BlockSpec((1,), lambda b, j, i: (b,)),
            pl.BlockSpec((1,), lambda b, j, i: (b,)),
            pl.BlockSpec(base_flat.shape, lambda b, j, i: (0, 0)),
        ],
        out_specs=[out_spec] * 4,
        out_shape=[
            jax.ShapeDtypeStruct((total, L), jnp.float32),
            jax.ShapeDtypeStruct((total, L), jnp.int32),
            jax.ShapeDtypeStruct((total, L), jnp.float32),
            jax.ShapeDtypeStruct((total, L), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="bin_top2_scan",
    )(queries_blocks, jnp.asarray(row_off, jnp.int32),
      jnp.asarray(sizes, jnp.int32), base_flat)
    return (jnp.concatenate([mn1, mn2], axis=1),
            jnp.concatenate([am1, am2], axis=1))


def bin_top2_reference(qs, base, n_valid, metric: Metric = "l2",
                       precision=jax.lax.Precision.HIGHEST):
    """Plain-JAX per-bin top-2 in the kernel's bin layout (one block).

    ``base`` rows must be a multiple of ``TILE``. Same return layout as
    :func:`bin_top2_blocks`; ties break toward the lower row, as the kernel's
    strict ``<`` update does.
    """
    d = max(qs.shape[1], base.shape[1])
    qs, base = _pad_cols(qs, d), _pad_cols(base, d)
    dots = jnp.dot(qs, base.T, precision=precision,
                   preferred_element_type=jnp.float32)
    if metric == "mips":
        dm = 1.0 - dots
    else:
        dm = (jnp.sum(qs * qs, 1)[:, None] + jnp.sum(base * base, 1)[None]
              - 2.0 * dots)
    m, n = dm.shape
    dm = jnp.where(jnp.arange(n)[None, :] < n_valid, dm, jnp.inf)
    # [m, tiles, BIN steps, WIDTH] -> bins are (tile, w) over the step axis
    dm4 = dm.reshape(m, n // TILE, BIN, WIDTH)
    order = jnp.argsort(dm4, axis=2, stable=True)[:, :, :2]
    mins = jnp.take_along_axis(dm4, order, axis=2)
    rows = (jnp.arange(n // TILE)[None, :, None, None] * TILE
            + order * WIDTH + jnp.arange(WIDTH)[None, None, None, :])

    def halves(x):  # [m, tiles, 2, WIDTH] -> [all first | all second]
        return jnp.concatenate([x[:, :, 0].reshape(m, -1),
                                x[:, :, 1].reshape(m, -1)], axis=1)

    return halves(mins), halves(rows)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "qb", "cap", "num_candidate_bins",
                     "interpret", "tq", "phase2"),
)
def fused_topk_blocks(
    queries_blocks: jnp.ndarray,
    base_flat: jnp.ndarray,
    row_off: jnp.ndarray,
    sizes: jnp.ndarray,
    k: int,
    metric: Metric = "l2",
    qb: int = TQ,
    cap: int = TILE,
    num_candidate_bins: int = 0,
    interpret: bool = False,
    tq: int = TQ,
    phase2: str = "exact",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-block top-k over the windows of :func:`bin_top2_blocks`.

    Returns ``(dists [nb*qb, k], LOCAL row ids [nb*qb, k])``: one kernel
    launch plus one batched candidate pick and rescore for the entire block
    list, the serving engine's whole scan stage.

    ``phase2`` picks the ``nc`` candidate bins from the bin summaries:
    "exact" = ``lax.top_k``; "approx" = ``lax.approx_max_k``, which on the
    GPU lowers to an exact selection as well. The exact f32 rescore then
    orders the survivors. ``nc`` defaults to ``max(k, 16)``.
    """
    d = padded_dim(max(base_flat.shape[1], queries_blocks.shape[1]))
    base_flat = _pad_cols(base_flat, d)
    queries_blocks = _pad_cols(queries_blocks, d)
    mins, argmins = bin_top2_blocks(queries_blocks, base_flat, row_off, sizes,
                                    metric, qb=qb, cap=cap, tq=tq,
                                    interpret=interpret)
    total = queries_blocks.shape[0]
    nc = min(num_candidate_bins or max(k, 16), mins.shape[1])
    if phase2 == "approx" and nc < mins.shape[1]:
        negb, bpos = jax.lax.approx_max_k(-mins, nc, recall_target=0.95)
    else:
        negb, bpos = jax.lax.top_k(-mins, nc)
    cand_local = jnp.take_along_axis(argmins, bpos, axis=1)
    row_off_rows = jnp.repeat(jnp.asarray(row_off, jnp.int32), qb,
                              total_repeat_length=total)
    cand = base_flat[row_off_rows[:, None] + cand_local]
    if metric == "mips":
        exact = 1.0 - jnp.einsum("md,mcd->mc", queries_blocks, cand,
                                 precision=jax.lax.Precision.HIGHEST)
    else:
        exact = jnp.sum((queries_blocks[:, None, :] - cand) ** 2, axis=-1)
    exact = jnp.where(jnp.isfinite(-negb), exact, jnp.inf)
    neg, pos = jax.lax.top_k(-exact, k)
    return -neg, jnp.take_along_axis(cand_local, pos, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "num_candidate_bins", "interpret", "tq",
                     "phase2"),
)
def fused_topk(
    qs: jnp.ndarray,
    base: jnp.ndarray,
    n_valid,
    k: int,
    metric: Metric = "l2",
    num_candidate_bins: int = 0,
    interpret: bool = False,
    tq: int = TQ,
    phase2: str = "exact",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k of each query in ``base`` (rows ``>= n_valid`` are padding):
    :func:`fused_topk_blocks` with one block. Returns
    ``(dists [m, k], row ids [m, k])``; padding rows never win.

    ``base`` rows must be a multiple of ``TILE`` and its columns a multiple
    of ``LANE`` to avoid a per-call copy; :func:`pad_base_for_scan` does both.
    """
    m = qs.shape[0]
    tq = min(tq, max(16, 1 << (max(m, 1) - 1).bit_length()))
    m_pad = -(-m // tq) * tq
    if m_pad != m:
        qs = jnp.pad(qs, ((0, m_pad - m), (0, 0)))
    n = base.shape[0]
    n_pad = -(-n // TILE) * TILE
    if n_pad != n:
        base = jnp.pad(base, ((0, n_pad - n), (0, 0)))
    d, i = fused_topk_blocks(
        qs, base, jnp.zeros(1, jnp.int32),
        jnp.reshape(jnp.asarray(n_valid, jnp.int32), (1,)), k, metric,
        qb=m_pad, cap=n_pad, num_candidate_bins=num_candidate_bins,
        interpret=interpret, tq=tq, phase2=phase2,
    )
    return d[:m], i[:m]


def pad_base_for_scan(points: np.ndarray) -> Tuple[np.ndarray, int]:
    """Pad base rows to a multiple of ``TILE`` and columns to a multiple of
    ``LANE``. Returns (padded base, n_valid): rows ``>= n_valid`` are
    padding, masked in the kernel."""
    n, d = points.shape
    base = np.zeros((-(-n // TILE) * TILE, padded_dim(d)), np.float32)
    base[:n, :d] = points
    return base, n
