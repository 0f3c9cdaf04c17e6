"""Streaming (beyond-device-memory) clustering for 100M-1B point datasets.

SURVEY.md §5.7: the reference handles scale by making each shard fit one
machine and by blocked aggregation (``kmeans.cpp:151-204``). Here the
dataset may exceed device memory (1B x 96 f32 = 384 GB): these routines stream
host-resident (memmap-able) points through the device in fixed-size chunks.

- :func:`streaming_kmeans` — Lloyd with device-side per-chunk assignment +
  segment sums, host-side accumulation across chunks. Arbitrarily large n;
  the device holds one chunk + centroids.
- :func:`streaming_capacity_partition` — balanced partition at scale:
  streaming Lloyd warm start, then distance-priority capacity-constrained
  assignment per chunk with global per-part budgets (the Pyramid assignment
  rule, partitioning.cpp:305-356, applied to centroids) — a scalable stand-in
  for BalancedKMeans when points exceed device memory.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpann_tpu.core.distances import Metric, pairwise_distances


@functools.partial(jax.jit, static_argnames=("metric",))
def _masked_nearest(chunk, centroids, open_mask, metric: Metric = "l2"):
    """(nearest OPEN centroid, its distance) per point, on device.

    Readback is [m] int32 + [m] f32 (8 bytes/point) instead of the full
    [m, k] distance matrix (a 64M-point admission pass would read back 16 GB
    otherwise)."""
    dm = pairwise_distances(chunk, centroids, metric)
    dm = jnp.where(open_mask[None, :], dm, jnp.inf)
    tgt = jnp.argmin(dm, axis=1).astype(jnp.int32)
    return tgt, jnp.take_along_axis(dm, tgt[:, None], axis=1)[:, 0]


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _chunk_stats(chunk, centroids, k: int, metric: Metric):
    if chunk.dtype != jnp.float32:  # byte chunks widen on device
        chunk = chunk.astype(jnp.float32)
    dm = pairwise_distances(chunk, centroids, metric)
    assign = jnp.argmin(dm, axis=1)
    sums = jax.ops.segment_sum(chunk, assign, num_segments=k)
    counts = jax.ops.segment_sum(
        jnp.ones(chunk.shape[0], jnp.float32), assign, num_segments=k
    )
    return sums, counts, assign.astype(jnp.int32)


def streaming_kmeans(
    points,                      # array-like / np.memmap [n, d]
    k: int,
    rounds: int = 10,
    chunk_rows: int = 1 << 20,
    metric: Metric = "l2",
    seed: int = 555,
    init: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means over host-resident points. Returns (centroids, assignment)."""
    n, d = points.shape
    rng = np.random.default_rng(seed)
    if init is None:
        idx = np.sort(rng.choice(n, size=min(k, n), replace=False))
        init = np.asarray(points[idx], np.float32)
    centroids = jnp.asarray(init, jnp.float32)
    # pad chunking to fixed shapes: the final partial chunk is padded with
    # repeats of its last row and its stats are corrected on host
    for _ in range(rounds):
        sums = np.zeros((k, d), np.float64)
        counts = np.zeros(k, np.float64)
        for s in range(0, n, chunk_rows):
            # keep source dtype: byte bases upload raw, widen on device
            chunk = np.asarray(points[s : s + chunk_rows])
            real = len(chunk)
            if real < chunk_rows and n > chunk_rows:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], chunk_rows - real, axis=0)]
                )
            cs, cc, _ = _chunk_stats(jnp.asarray(chunk), centroids, k, metric)
            cs, cc = np.asarray(cs, np.float64), np.asarray(cc, np.float64)
            if real < len(chunk):
                # subtract the padded repeats' contribution
                pad = len(chunk) - real
                last = chunk[-1]
                dm_last = np.asarray(
                    pairwise_distances(
                        jnp.asarray(last[None]), centroids, metric
                    )
                )
                c_last = int(dm_last.argmin())
                cs[c_last] -= pad * last.astype(np.float64)
                cc[c_last] -= pad
            sums += cs
            counts += cc
        new_c = np.where(
            counts[:, None] > 0, sums / np.maximum(counts, 1)[:, None],
            np.asarray(centroids, np.float64),
        ).astype(np.float32)
        if metric == "mips":
            norms = np.sqrt(np.maximum((new_c ** 2).sum(1), 1e-12))
            new_c = new_c / norms[:, None]
        centroids = jnp.asarray(new_c)

    assignment = np.empty(n, np.int32)
    for s in range(0, n, chunk_rows):
        chunk = np.asarray(points[s : s + chunk_rows])
        real = len(chunk)
        if real < chunk_rows and n > chunk_rows:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], chunk_rows - real, axis=0)]
            )
        _, _, a = _chunk_stats(jnp.asarray(chunk), centroids, k, metric)
        assignment[s : s + real] = np.asarray(a)[:real]
    return np.asarray(centroids), assignment


def admit_priority(target: np.ndarray, d_best: np.ndarray,
                   room: np.ndarray):
    """Vectorized distance-priority admission under per-part ``room``
    (MUTATED in place). Returns ``(placed_local, placed_parts,
    rest_local)`` — local indices into ``target`` of admitted points, their
    parts, and the indices that could not be placed in their nearest open
    part. The admission order (closest-first within each part) is the
    Pyramid assignment rule, ``partitioning.cpp:305-356``."""
    prio = np.argsort(d_best, kind="stable")
    t_prio = target[prio]
    by_t = np.argsort(t_prio, kind="stable")
    final = prio[by_t]
    t_fin = target[final]
    within = np.arange(len(final)) - np.searchsorted(t_fin, t_fin)
    ok = within < room[t_fin]
    np.subtract.at(room, t_fin[ok], 1)
    return final[ok], t_fin[ok], final[~ok]


class RepSet:
    """Padded device-resident representative set for nearest-OPEN-part
    queries (shared by :func:`capacity_stream_assign` and the fused
    relayout assigner, :mod:`gpann_tpu.search.relayout`)."""

    def __init__(self, reps: np.ndarray, rep_labels: np.ndarray,
                 metric: Metric = "l2") -> None:
        reps = np.ascontiguousarray(reps, np.float32)
        rep_labels = np.asarray(rep_labels, np.int64)
        r = len(reps)
        # pad reps to a lane multiple (stable compile shapes across slightly
        # different aggregate counts); padding reps are permanently closed
        r_pad = -(-r // 128) * 128
        if r_pad != r:
            reps = np.concatenate(
                [reps, np.zeros((r_pad - r, reps.shape[1]), np.float32)]
            )
            rep_labels = np.concatenate(
                [rep_labels, np.zeros(r_pad - r, np.int64)]
            )
        self.labels = rep_labels
        self.valid = np.arange(r_pad) < r
        self.rj = jnp.asarray(reps)
        self.metric: Metric = metric
        self.r_pad = r_pad

    def max_chunk_rows(self, chunk_rows: int) -> int:
        """Bound the masked-argmin's [m, r_pad] f32 device tile to ~4 GB
        (a conservative limit: 1M x 4097 rows would take 17.2 GB)."""
        max_rows = max(65536, (1 << 30) // self.r_pad)
        return min(chunk_rows, 1 << (max_rows.bit_length() - 1))

    def nearest_open(self, chunk: np.ndarray, room: np.ndarray):
        """(nearest open part, distance) per row; power-of-two row padding
        keeps compiles O(log n) across ragged final chunks and shrinking
        retry rounds."""
        real = len(chunk)
        m_pad = max(256, 1 << (real - 1).bit_length())
        if m_pad != real:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], m_pad - real, axis=0)]
            )
        open_mask = jnp.asarray((room > 0)[self.labels] & self.valid)
        tgt, db = _masked_nearest(jnp.asarray(chunk), self.rj, open_mask,
                                  self.metric)
        return self.labels[np.asarray(tgt)[:real]], np.asarray(db)[:real]


def capacity_stream_assign(
    points,
    reps: np.ndarray,
    rep_labels: np.ndarray,
    k: int,
    eps: float = 0.05,
    chunk_rows: int = 1 << 20,
    metric: Metric = "l2",
) -> np.ndarray:
    """Assign every point to the part of its nearest representative, under
    per-part capacity ``(1+eps)*ceil(n/k)`` — the reference's Pyramid
    assignment rule (``partitioning.cpp:305-356``) applied to any labeled
    representative set (centroids, aggregates of a subsample-GP partition,
    ...), streamed in fixed chunks through the device.

    Per chunk: masked nearest-OPEN-representative on device (8 B/point
    readback), distance-priority admission against global per-part room on
    host, retry rounds over the leftovers (a representative is OPEN while
    its part has room; total capacity k*cap >= n guarantees termination).
    """
    n = points.shape[0]
    rs = RepSet(reps, rep_labels, metric=metric)
    chunk_rows = rs.max_chunk_rows(chunk_rows)
    cap = int((1.0 + eps) * np.ceil(n / k))
    room = np.full(k, cap, np.int64)
    part = np.full(n, -1, np.int32)

    def admit(global_ids: np.ndarray, target: np.ndarray,
              d_best: np.ndarray) -> np.ndarray:
        placed, pparts, rest = admit_priority(target, d_best, room)
        part[global_ids[placed]] = pparts
        return global_ids[rest]

    leftovers = []
    for s in range(0, n, chunk_rows):
        # keep source dtype: byte bases upload raw, widen on device
        chunk = np.asarray(points[s : s + chunk_rows])
        tgt, db = rs.nearest_open(chunk, room)
        rest = admit(np.arange(s, s + len(chunk)), tgt, db)
        leftovers.append(rest)
    rest = np.concatenate(leftovers) if leftovers else np.empty(0, np.int64)
    while len(rest):
        tgt, db = rs.nearest_open(np.asarray(points[rest]), room)
        rest = admit(rest, tgt, db)
    return part


def streaming_capacity_partition(
    points,
    k: int,
    eps: float = 0.05,
    rounds: int = 10,
    chunk_rows: int = 1 << 20,
    metric: Metric = "l2",
    seed: int = 555,
    train_sample: Optional[int] = None,
) -> np.ndarray:
    """Balanced partition for out-of-memory datasets.

    Streaming Lloyd, then per-chunk distance-priority admission under global
    per-part budgets via :func:`capacity_stream_assign`; unadmitted points
    spill to their nearest part with room. Guarantees max part size <=
    (1+eps)*ceil(n/k).

    ``train_sample``: train the Lloyd centroids on an in-RAM uniform
    subsample of that size instead of streaming every round over the full
    set — the reference's own big-input strategy (Pyramid subsamples to 10M,
    partitioning.cpp:271-276). Only the single admission pass then touches
    all n points, cutting the full-base passes from ``rounds+2`` to 2.
    """
    n, d = points.shape
    if train_sample is not None and n > train_sample:
        from gpann_tpu.cluster.kmeans import kmeans as _lloyd

        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(n, size=train_sample, replace=False))
        sample = np.asarray(points[idx], np.float32)
        centroids, _ = _lloyd(sample, k=k, metric=metric, rounds=rounds,
                              seed=seed)
    else:
        centroids, _ = streaming_kmeans(
            points, k, rounds=rounds, chunk_rows=chunk_rows, metric=metric,
            seed=seed,
        )
    return capacity_stream_assign(
        points, centroids, np.arange(k), k, eps=eps, chunk_rows=chunk_rows,
        metric=metric,
    )
