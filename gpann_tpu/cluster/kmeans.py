"""K-means family: random sampling, Lloyd, balanced k-means.

Reference parity: ``src/kmeans.cpp``.

Accelerator redesign notes:

- The assignment step (reference ``kmeans.cpp:12-27`` — parallel brute-force
  top-1) is one [n,d]x[d,k] matmul + row argmin.
- Aggregation (``kmeans.cpp:72-100`` and the blocked-atomic variant at
  ``:151-204``) becomes ``jax.ops.segment_sum`` — no atomics exist or are
  needed.
- ``BalancedKMeans`` (``kmeans.cpp:253-515``) runs 1000 *sequential*
  mini-batches per round with in-flight atomic centroid updates — inherently
  scalar-sequential. The accelerator variant keeps the *semantics* (penalized
  score ``dist + penalty * cluster_size``, BKM+ penalty schedule, keep-best
  balanced solution, final greedy re-migration) but applies moves in
  batched-synchronous mini-batches under ``lax.scan``: every mini-batch scores
  all points against the current sizes, applies all its moves at once, and
  refreshes sizes/centroids before the next mini-batch.
- Empty clusters: the reference compacts them away (``kmeans.cpp:29-50``);
  with XLA's static shapes we keep k fixed and re-seed empty centroids from
  the points currently farthest from their centroid (a standard k-means
  repair that also prevents dead centroids).
- MIPS ("spherical") k-means renormalizes centroids to the mean point norm
  (``kmeans.cpp:85-99``).

Seeding follows the reference's fixed-seed convention (seed 555 patterns).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpann_tpu.core.distances import (
    Metric,
    pairwise_distances,
    pos_distance_offset,
    sq_norms,
)

DEFAULT_ROUNDS = 20  # reference kmeans.cpp:228-244


def random_sample(points: np.ndarray, k: int, seed: int = 555) -> np.ndarray:
    """Seeded sample of k distinct rows as initial centroids
    (reference RandomSample, kmeans.cpp:207-226)."""
    n = points.shape[0]
    k = min(k, n)
    idx = np.random.default_rng(seed).choice(n, size=k, replace=False)
    return np.asarray(points[np.sort(idx)], dtype=np.float32)


def _aggregate(points, assignment, k, metric, prev_centroids, weights=None):
    """(Weighted) mean of members per cluster; empty clusters keep previous
    centroid. Returns (centroids [k,d], sizes [k])."""
    if weights is None:
        weights = jnp.ones(points.shape[0], jnp.float32)
    sums = jax.ops.segment_sum(points * weights[:, None], assignment, num_segments=k)
    sizes = jax.ops.segment_sum(weights, assignment, num_segments=k)
    means = sums / jnp.maximum(sizes, 1.0)[:, None]
    if metric == "mips":
        # spherical: scale centroids to unit-ish norm (kmeans.cpp:85-99 uses
        # the mean point norm; unit works identically for ranking)
        norms = jnp.sqrt(jnp.maximum(sq_norms(means), 1e-12))
        means = means / norms[:, None]
    centroids = jnp.where(sizes[:, None] > 0, means, prev_centroids)
    return centroids, sizes


@functools.partial(jax.jit, static_argnames=("k", "metric", "rounds"))
def _lloyd(points, init_centroids, k: int, metric: Metric, rounds: int,
           weights=None, k_valid=None):
    """``k_valid`` (traced scalar, optional): only centroid columns
    < k_valid participate in the argmin — callers pad the centroid count to
    a fixed bucket so XLA compiles one program per bucket instead of one per
    exact k (compiles cost 20-75 s on this backend)."""
    col_ok = None if k_valid is None else jnp.arange(k)[None, :] < k_valid

    def assign_step(centroids):
        dm = pairwise_distances(points, centroids, metric)
        if col_ok is not None:
            dm = jnp.where(col_ok, dm, jnp.inf)
        return dm

    def body(carry, _):
        centroids = carry
        dm = assign_step(centroids)
        assignment = jnp.argmin(dm, axis=1)
        centroids, sizes = _aggregate(points, assignment, k, metric, centroids,
                                      weights)
        return centroids, None

    centroids, _ = jax.lax.scan(body, init_centroids, None, length=rounds)
    dm = assign_step(centroids)
    assignment = jnp.argmin(dm, axis=1).astype(jnp.int32)
    obj = jnp.sum(
        jnp.take_along_axis(dm, assignment[:, None], axis=1)
        + pos_distance_offset(metric)
    )
    return centroids, assignment, obj


def kmeans(
    points: np.ndarray,
    centroids: Optional[np.ndarray] = None,
    k: Optional[int] = None,
    metric: Metric = "l2",
    rounds: int = DEFAULT_ROUNDS,
    seed: int = 555,
    weights: Optional[np.ndarray] = None,
    k_pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means (reference KMeans, kmeans.cpp:228-244).

    ``weights`` (optional, [n] float) weight the centroid aggregation;
    zero-weight rows are shape padding that never influences centroids.
    ``k_pad_to``: compile-shape bucket for the centroid count — the program
    runs with k_pad_to centroid slots of which only k are live (masked
    argmin), so sweeps over many k values reuse ONE compiled program.
    Returns (centroids [k,d] float32, assignment [n] int32).
    """
    points = np.ascontiguousarray(points, dtype=np.float32)
    if centroids is None:
        if k is None:
            raise ValueError("pass either centroids or k")
        sample_pool = points if weights is None else points[weights > 0]
        centroids = random_sample(sample_pool, k, seed)
    k = centroids.shape[0]
    if k == 0 or points.shape[0] == 0:
        return np.asarray(centroids, np.float32), np.zeros(points.shape[0], np.int32)
    w = None if weights is None else jnp.asarray(weights, jnp.float32)
    if k_pad_to and k_pad_to > k:
        init = np.concatenate(
            [np.asarray(centroids, np.float32),
             np.broadcast_to(np.asarray(centroids[:1], np.float32),
                             (k_pad_to - k, centroids.shape[1]))]
        )
        c, a, _ = _lloyd(jnp.asarray(points), jnp.asarray(init), k_pad_to,
                         metric, rounds, w, jnp.int32(k))
        return np.asarray(c)[:k], np.asarray(a)
    c, a, _ = _lloyd(jnp.asarray(points), jnp.asarray(centroids, jnp.float32), k,
                     metric, rounds, w)
    return np.asarray(c), np.asarray(a)


def objective_value(
    points: np.ndarray, centroids: np.ndarray, assignment: np.ndarray,
    metric: Metric = "l2",
) -> float:
    """Sum of (pos-shifted) distances to assigned centroids
    (reference ObjectiveValue, kmeans.cpp:102-116)."""
    dm = pairwise_distances(jnp.asarray(points), jnp.asarray(centroids), metric)
    d = jnp.take_along_axis(dm, jnp.asarray(assignment)[:, None], axis=1)
    return float(jnp.sum(d + pos_distance_offset(metric)))


# ---------------------------------------------------------------------------
# Balanced k-means (BKM+ penalty method, kmeans.cpp:253-515)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "num_batches")
)
def _balanced_round(points, centroids, assignment, penalty, max_size, k: int,
                    metric: Metric, num_batches: int):
    """One penalized round: scan over mini-batches, batched-synchronous moves.

    Within each mini-batch, a point moves to ``argmin_c dist(p,c) +
    penalty * size[c]`` (the BKM+ score, kmeans.cpp:411-455), except moves
    into clusters already at ``max_size`` are masked. Also returns the
    minimum penalty that would have enabled a balancing move out of an
    overloaded cluster (drives the penalty schedule, kmeans.cpp:295-301).
    """
    n = points.shape[0]
    bs = n // num_batches  # caller pads n to a multiple
    point_batches = points.reshape(num_batches, bs, -1)
    assign_batches = assignment.reshape(num_batches, bs)
    sizes0 = jax.ops.segment_sum(jnp.ones(n, jnp.float32), assignment, num_segments=k)

    def body(carry, inp):
        centroids, sizes, min_needed = carry
        pts, cur = inp
        dm = pairwise_distances(pts, centroids, metric) + pos_distance_offset(metric)
        cur_d = jnp.take_along_axis(dm, cur[:, None], axis=1)[:, 0]
        score = dm + penalty * sizes[None, :]
        cur_score = cur_d + penalty * (sizes[cur] - 1.0)  # leaving frees a slot
        # can't move into full clusters; can't "move" to own cluster
        own = jax.nn.one_hot(cur, k, dtype=jnp.bool_)
        full = (sizes >= max_size)[None, :] & ~own
        score = jnp.where(full | own, jnp.inf, score)
        best = jnp.argmin(score, axis=1)
        best_score = jnp.take_along_axis(score, best[:, None], axis=1)[:, 0]
        do_move = best_score < cur_score
        new_assign = jnp.where(do_move, best, cur).astype(jnp.int32)

        # minimum penalty that would push a point out of an overloaded cluster:
        # need dist_new + pen*size_new < dist_cur + pen*(size_cur-1)
        overloaded = sizes[cur] > max_size
        best_d = jnp.take_along_axis(dm, best[:, None], axis=1)[:, 0]
        dgap = best_d - cur_d
        sgap = (sizes[cur] - 1.0) - sizes[best]
        cand_pen = jnp.where(
            overloaded & (sgap > 0), dgap / jnp.maximum(sgap, 1e-9), jnp.inf
        )
        min_needed = jnp.minimum(min_needed, jnp.min(cand_pen))

        # apply the batch's moves synchronously
        delta = (
            jax.ops.segment_sum(jnp.ones(bs, jnp.float32), new_assign, num_segments=k)
            - jax.ops.segment_sum(jnp.ones(bs, jnp.float32), cur, num_segments=k)
        )
        sizes = sizes + delta
        moved = do_move[:, None]
        sum_delta = (
            jax.ops.segment_sum(jnp.where(moved, pts, 0.0), new_assign, num_segments=k)
            - jax.ops.segment_sum(jnp.where(moved, pts, 0.0), cur, num_segments=k)
        )
        # incremental centroid refresh (update_centroids, kmeans.cpp:338-370)
        centroids = jnp.where(
            sizes[:, None] > 0,
            (centroids * (sizes - delta)[:, None] + sum_delta)
            / jnp.maximum(sizes, 1.0)[:, None],
            centroids,
        )
        if metric == "mips":
            centroids = centroids / jnp.sqrt(
                jnp.maximum(sq_norms(centroids), 1e-12)
            )[:, None]
        return (centroids, sizes, min_needed), new_assign

    (centroids, sizes, min_needed), new_assign = jax.lax.scan(
        body, (centroids, sizes0, jnp.inf), (point_batches, assign_batches)
    )
    return centroids, new_assign.reshape(n), min_needed


def balanced_kmeans(
    points: np.ndarray,
    k: int,
    eps: float = 0.05,
    metric: Metric = "l2",
    max_rounds: int = 150,
    num_batches: int = 32,
    seed: int = 555,
    max_size: Optional[int] = None,
    refine_rounds: int = 20,
    train_sample: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced k-means: max cluster size <= (1+eps)*ceil(n/k).

    ``train_sample``: if set and n exceeds it, the Lloyd warm start trains
    centroids on a uniform subsample of that size (the reference's own
    strategy for huge inputs — Pyramid subsamples to 10M,
    partitioning.cpp:271-276); the capacity assignment and refinement still
    see every point, so the balance guarantee is unchanged.

    Role parity: reference BalancedKMeans (kmeans.cpp:253-515). The
    reference's 1000 *sequential* mini-batches with in-flight atomic updates
    don't translate to batched-synchronous execution: once the BKM+ penalty
    grows large enough to force balance (which, for well-separated clusters,
    it must), the size term dominates every score simultaneously, the whole
    assignment scrambles in one round and the centroids collapse toward the
    global mean — measured first-probe oracle recall fell from ~0.72 to 0.19.

    Redesign with the same guarantee (max size <= cap) and better
    objectives:

    1. Lloyd warm start (structured centroids).
    2. Distance-priority capacity assignment: points claim their nearest
       centroid in globally-nearest-first order under per-cluster capacity
       (the same admission rule as Pyramid's constrained assignment,
       partitioning.cpp:305-356).
    3. Capacity-constrained local refinement: batched-synchronous rounds of
       "move to a strictly closer non-full cluster" (the penalty=0 special
       case of the BKM+ score), with incremental centroid updates —
       objective decreases monotonically, balance is preserved.
    4. Greedy re-migration safety net (kmeans.cpp:484-515).
    Returns (centroids, assignment).
    """
    points = np.ascontiguousarray(points, dtype=np.float32)
    n = points.shape[0]
    if max_size is None:
        max_size = int((1.0 + eps) * np.ceil(n / k))
    if train_sample and n > train_sample:
        idx = np.random.default_rng(seed).choice(
            n, size=train_sample, replace=False
        )
        centroids, _ = kmeans(points[idx], k=k, metric=metric, seed=seed)
    else:
        centroids, _ = kmeans(points, k=k, metric=metric, seed=seed)

    # 2. capacity assignment by global distance priority
    assignment = _capacity_priority_assign(points, centroids, max_size, metric)

    pad = (-n) % num_batches
    if pad:
        # pad with copies of the last point; padded entries are pinned to
        # their argmin and sliced away, slightly perturbing sizes — harmless
        # at these scales, and removed before the final rebalance.
        pts_p = np.concatenate([points, np.repeat(points[-1:], pad, axis=0)])
        asg_p = np.concatenate([assignment, np.repeat(assignment[-1:], pad)])
    else:
        pts_p, asg_p = points, assignment

    pts_j = jnp.asarray(pts_p)
    cj, aj = jnp.asarray(centroids), jnp.asarray(asg_p)
    best_assignment = assignment
    best_obj = objective_value(points, centroids, assignment, metric)
    for _ in range(refine_rounds):
        cj, aj, _ = _balanced_round(
            pts_j, cj, aj, jnp.float32(0.0), float(max_size), k, metric,
            num_batches,
        )
        a_np = np.asarray(aj)[:n]
        sizes = np.bincount(a_np, minlength=k)
        if sizes.max() > max_size:
            break  # padding perturbation pushed over; rebalance below fixes it
        obj = objective_value(points, np.asarray(cj), a_np, metric)
        if obj < best_obj - 1e-6 * abs(best_obj):
            best_obj, best_assignment = obj, a_np.copy()
        else:
            break

    assignment = rebalance_greedy(points, np.asarray(cj), best_assignment,
                                  max_size, metric)
    centroids_f, sizes = _final_centroids(points, assignment, k, metric)
    return centroids_f, assignment


def _capacity_priority_assign(
    points: np.ndarray, centroids: np.ndarray, max_size: int,
    metric: Metric, block: int = 1 << 20,
) -> np.ndarray:
    """Globally-nearest-first assignment under per-cluster capacity.

    Distances per block on device; admission fully vectorized on host
    (sort by distance, per-cluster rank < room). Unplaced points retry
    against clusters with room.
    """
    from gpann_tpu.cluster.streaming import _masked_nearest

    n = points.shape[0]
    k = centroids.shape[0]
    cj = jnp.asarray(centroids)
    part = np.full(n, -1, np.int32)
    room = np.full(k, max_size, np.int64)

    def nearest_open(chunk: np.ndarray):
        # device-side masked argmin: reads back 8 bytes/point instead of the
        # [m, k] distance matrix; power-of-two row padding bounds compiles
        # across ragged retry rounds
        real = len(chunk)
        m_pad = max(256, 1 << (real - 1).bit_length())
        if m_pad != real:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], m_pad - real, axis=0)]
            )
        tgt, db = _masked_nearest(
            jnp.asarray(chunk), cj, jnp.asarray(room > 0), metric
        )
        return np.asarray(tgt)[:real], np.asarray(db)[:real]

    def admit(ids: np.ndarray, target: np.ndarray,
              d_best: np.ndarray) -> np.ndarray:
        prio = np.argsort(d_best, kind="stable")
        by_t = np.argsort(target[prio], kind="stable")
        final = prio[by_t]
        t_fin = target[final]
        within = np.arange(len(final)) - np.searchsorted(t_fin, t_fin)
        ok = within < room[t_fin]
        part[ids[final[ok]]] = t_fin[ok]
        np.subtract.at(room, t_fin[ok], 1)
        return ids[final[~ok]]

    rest_parts = []
    for s in range(0, n, block):
        tgt, db = nearest_open(np.asarray(points[s : s + block], np.float32))
        rest_parts.append(admit(np.arange(s, min(s + block, n)), tgt, db))
    rest = np.concatenate(rest_parts) if rest_parts else np.empty(0, np.int64)
    while len(rest):
        tgt, db = nearest_open(np.asarray(points[rest], np.float32))
        rest = admit(rest, tgt, db)
    return part


def rebalance_greedy(
    points: np.ndarray, centroids: np.ndarray, assignment: np.ndarray,
    max_size: int, metric: Metric = "l2",
) -> np.ndarray:
    """Greedy re-migration of overloaded clusters' points to the closest
    non-full cluster (reference final rebalance, kmeans.cpp:484-515)."""
    assignment = assignment.copy()
    k = centroids.shape[0]
    sizes = np.bincount(assignment, minlength=k)
    dm = np.asarray(
        pairwise_distances(jnp.asarray(points), jnp.asarray(centroids), metric)
    )
    for c in np.nonzero(sizes > max_size)[0]:
        members = np.nonzero(assignment == c)[0]
        # evict the members that lose least by moving
        alt = dm[members].copy()
        alt[:, c] = np.inf
        regret = alt.min(axis=1) - dm[members, c]
        order = members[np.argsort(regret)]
        for p in order:
            if sizes[c] <= max_size:
                break
            targets = np.argsort(dm[p])
            for t in targets:
                if t != c and sizes[t] < max_size:
                    assignment[p] = t
                    sizes[t] += 1
                    sizes[c] -= 1
                    break
            else:
                raise RuntimeError("no rebalance target found")  # kmeans.cpp:510
    return assignment


def _final_centroids(points, assignment, k, metric):
    sums = np.zeros((k, points.shape[1]), np.float64)
    np.add.at(sums, assignment, points)
    sizes = np.bincount(assignment, minlength=k)
    cents = (sums / np.maximum(sizes, 1)[:, None]).astype(np.float32)
    if metric == "mips":
        norms = np.sqrt(np.maximum((cents * cents).sum(1), 1e-12))
        cents = cents / norms[:, None]
    return cents, sizes
