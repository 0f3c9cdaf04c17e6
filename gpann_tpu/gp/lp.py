"""Balanced graph partitioner — the KaMinPar replacement.

The reference's single external-partitioner call site is
``PartitionGraphWithKaMinPar`` (``src/partitioning.cpp:172-199``): a
shared-memory multilevel partitioner invoked with k, an eps-balance
constraint, optional node weights, and a default/strong preset. Per
SURVEY.md §7, quality is judged by *downstream oracle/routing recall*, not
edge-cut parity.

Accelerator multilevel design:

1. **Coarsening** (host, NumPy): repeated heavy-edge *mutual matching* — each
   node proposes to its heaviest neighbor, mutual proposals contract. Node
   weights and edge multiplicities accumulate. Stops near
   ``coarse_target`` nodes.
2. **Initial partition** (host): weight-balanced greedy BFS growth from k
   spread-out seeds on the coarsest graph, then LP refinement.
3. **Refinement** (device, JAX): size-constrained label propagation. Each
   round computes every node's affinity to each of the k parts (one
   scatter-add over edges — a segment op, no atomics), gains vs. current
   part, and admits moves by gain priority under the per-part weight budget
   (sort by (target, -gain), segmented cumulative weight <= remaining
   capacity). Rounds alternate over random node subsets to avoid oscillation.

The partitioner is deterministic given ``seed``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Device: size-constrained LP refinement
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k",))
def _refine_round(u, v, w, part, node_w, cap, active, k: int):
    """One LP round. Returns the new partition.

    u, v, w      — directed edge list (both directions present), weights f32
    part         — [n] int32 current parts
    node_w       — [n] f32 node weights
    cap          — scalar f32 max part weight
    active       — [n] bool, nodes allowed to move this round
    """
    n = part.shape[0]
    aff = jnp.zeros((n, k), jnp.float32).at[u, part[v]].add(w)
    own = jnp.take_along_axis(aff, part[:, None], axis=1)[:, 0]
    # block moving into own part
    aff = aff.at[jnp.arange(n), part].set(-jnp.inf)
    target = jnp.argmax(aff, axis=1).astype(jnp.int32)
    gain = jnp.max(aff, axis=1) - own

    sizes = jnp.zeros(k, jnp.float32).at[part].add(node_w)
    room = cap - sizes  # capacity left per part (conservative: ignores outflow)

    want = active & (gain > 0)
    # sort by gain desc (stable), then by target (stable) -> within-target
    # nodes appear in descending gain order
    by_gain = jnp.argsort(-jnp.where(want, gain, -jnp.inf), stable=True)
    t_sorted = target[by_gain]
    by_target = jnp.argsort(t_sorted, stable=True)
    order = by_gain[by_target]
    t_ord = target[order]
    w_ord = jnp.where(want[order], node_w[order], 0.0)
    cum = jnp.cumsum(w_ord)
    # start-of-group cumulative weight per target part
    first_in_group = jnp.concatenate(
        [jnp.ones(1, bool), t_ord[1:] != t_ord[:-1]]
    )
    group_base = jnp.where(first_in_group, cum - w_ord, 0.0)
    group_base = jax.lax.associative_scan(jnp.maximum, group_base)
    within = cum - group_base
    admit_ord = want[order] & (within <= room[t_ord])
    admit = jnp.zeros(n, bool).at[order].set(admit_ord)
    return jnp.where(admit, target, part)


@functools.partial(jax.jit, static_argnames=("k",))
def _edge_cut(u, v, w, part, k: int):
    return jnp.sum(jnp.where(part[u] != part[v], w, 0.0)) / 2.0


def refine(
    u: np.ndarray,
    v: np.ndarray,
    w: np.ndarray,
    part: np.ndarray,
    node_w: np.ndarray,
    k: int,
    cap: float,
    rounds: int = 12,
    seed: int = 555,
) -> np.ndarray:
    """Run LP refinement rounds on device; keeps the best feasible cut."""
    uj = jnp.asarray(u, jnp.int32)
    vj = jnp.asarray(v, jnp.int32)
    wj = jnp.asarray(w, jnp.float32)
    nw = jnp.asarray(node_w, jnp.float32)
    pj = jnp.asarray(part, jnp.int32)
    rng = np.random.default_rng(seed)
    n = len(part)
    best = np.asarray(pj)
    best_cut = float(_edge_cut(uj, vj, wj, pj, k))
    stale = 0
    for r in range(rounds):
        frac = 1.0 if r < 2 else 0.7  # damp later rounds against oscillation
        active = jnp.asarray(rng.random(n) < frac)
        pj = _refine_round(uj, vj, wj, pj, nw, jnp.float32(cap), active, k)
        cut = float(_edge_cut(uj, vj, wj, pj, k))
        if cut < best_cut - 1e-9:
            best_cut = cut
            best = np.asarray(pj)
            stale = 0
        else:
            stale += 1
            if stale >= 3:
                break
    return best


# ---------------------------------------------------------------------------
# Host: coarsening by mutual heavy-edge matching
# ---------------------------------------------------------------------------


def _heaviest_neighbor(u, v, w, n, rng):
    """For each node, its heaviest neighbor (random tie-break)."""
    jitter = rng.random(len(w)).astype(np.float32) * 1e-3
    order = np.lexsort((w + jitter, u))  # per-u ascending weight; last = max
    uu, vv = u[order], v[order]
    last = np.zeros(len(uu), dtype=bool)
    last[:-1] = uu[:-1] != uu[1:]
    last[-1] = True
    h = np.full(n, -1, dtype=np.int64)
    h[uu[last]] = vv[last]
    return h


def _csr_from_sorted_coo(u, v, n):
    """CSR indptr for a COO edge list already sorted by u."""
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, u + 1, 1)
    return np.cumsum(indptr)


def coarsen_once(u, v, w, node_w, max_node_w, rng):
    """One mutual-matching contraction. Returns (mapping [n]->coarse id,
    coarse u/v/w, coarse node weights). Uses the native C++ matcher when
    built (gpann_tpu/native/src/graph_ops.cc), NumPy otherwise."""
    from gpann_tpu import native

    n = len(node_w)
    idx = np.arange(n)
    partner = None
    if native.available():
        indptr = _csr_from_sorted_coo(u, v, n)
        partner = native.heavy_edge_matching(
            indptr, v, w, node_w, max_node_w, rng.integers(2**62)
        )
    if partner is None:
        h = _heaviest_neighbor(u, v, w, n, rng)
        ok = (h >= 0) & (h[h.clip(min=0)] == idx)  # mutual
        partner = np.where(ok, h, idx)
        # avoid over-heavy contracted nodes
        too_heavy = node_w + node_w[partner.clip(min=0)] > max_node_w
        partner = np.where(too_heavy, idx, partner)
    rep = np.minimum(idx, partner)
    mapping = np.full(n, -1, dtype=np.int64)
    roots = rep == idx
    mapping[roots] = np.arange(int(roots.sum()))
    mapping = mapping[rep]  # followers inherit their root's coarse id
    nc = int(roots.sum())

    cu, cv = mapping[u], mapping[v]
    keep = cu != cv
    cu, cv, cw = cu[keep], cv[keep], w[keep]
    key = cu * nc + cv
    uniq, inv = np.unique(key, return_inverse=True)
    agg_w = np.zeros(len(uniq), np.float32)
    np.add.at(agg_w, inv, cw)
    cu = (uniq // nc).astype(np.int64)
    cv = (uniq % nc).astype(np.int64)
    cnw = np.zeros(nc, np.float64)
    np.add.at(cnw, mapping, node_w)
    return mapping, cu, cv, agg_w, cnw.astype(np.float32)


def _initial_partition(u, v, w, node_w, k, cap, rng):
    """Greedy balanced region growing on the coarsest graph (host).

    Native C++ path when built; NumPy/Python fallback below."""
    from gpann_tpu import native

    n = len(node_w)
    if native.available():
        indptr = _csr_from_sorted_coo(u, v, n)
        part = native.bfs_grow_partition(
            indptr, v, node_w, k, cap, rng.integers(2**62)
        )
        if part is not None and (part >= 0).all():
            return part
    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, np.float64)
    # spread seeds: random start, then farthest-by-BFS-hops heuristic
    adj_order = np.lexsort((v, u))
    su, sv, sw = u[adj_order], v[adj_order], w[adj_order]
    starts = np.searchsorted(su, np.arange(n + 1))
    seeds = [int(rng.integers(n))]
    dist = np.full(n, np.inf)
    for _ in range(k - 1):
        frontier = [seeds[-1]]
        dist[seeds[-1]] = 0
        dd = 0
        while frontier:
            dd += 1
            nxt = []
            for node in frontier:
                for e in range(starts[node], starts[node + 1]):
                    t = sv[e]
                    if dist[t] > dd:
                        dist[t] = dd
                        nxt.append(t)
            frontier = nxt
        far = int(np.argmax(np.where(np.isinf(dist), -1, dist)))
        if dist[far] <= 0 or far in seeds:
            far = int(rng.integers(n))
        seeds.append(far)
    for p, s in enumerate(seeds):
        if part[s] == -1:
            part[s] = p
            sizes[p] += node_w[s]
    # greedy BFS growth: repeatedly grow the lightest part
    import heapq

    frontiers = {p: set() for p in range(k)}
    for p in range(k):
        for s in np.nonzero(part == p)[0]:
            for e in range(starts[s], starts[s + 1]):
                if part[sv[e]] == -1:
                    frontiers[p].add(int(sv[e]))
    unassigned = int((part == -1).sum())
    while unassigned > 0:
        p = int(np.argmin(np.where(sizes <= cap, sizes, np.inf)))
        cands = [c for c in frontiers[p] if part[c] == -1]
        if not cands:
            # take any unassigned node
            rest = np.nonzero(part == -1)[0]
            c = int(rest[0])
        else:
            c = cands[0]
        part[c] = p
        sizes[p] += node_w[c]
        frontiers[p].discard(c)
        for e in range(starts[c], starts[c + 1]):
            if part[sv[e]] == -1:
                frontiers[p].add(int(sv[e]))
        unassigned -= 1
    return part


def _force_balance(u, v, w, part, node_w, k, cap):
    """Post-pass: move lowest-affinity nodes out of overweight parts.

    Native C++ path when built; NumPy fallback below."""
    from gpann_tpu import native

    n = len(part)
    if native.available():
        indptr = _csr_from_sorted_coo(u, v, n)
        out = native.force_balance(indptr, v, w, node_w, k, cap, part)
        if out is not None:
            sizes = np.zeros(k)
            np.add.at(sizes, out, node_w)
            if sizes.max() <= cap + 1e-6:
                return out
    sizes = np.zeros(k, np.float64)
    np.add.at(sizes, part, node_w)
    if (sizes <= cap).all():
        return part
    aff = np.zeros((n, k), np.float32)
    np.add.at(aff, (u, part[v]), w)
    part = part.copy()
    for p in np.argsort(-sizes):
        while sizes[p] > cap:
            members = np.nonzero(part == p)[0]
            # evict members with least affinity to p, preferring targets w/ room
            own_aff = aff[members, p]
            order = members[np.argsort(own_aff)]
            moved = False
            for node in order[: max(1, len(order) // 4)]:
                targets = np.argsort(-aff[node])
                for t in targets:
                    if t != p and sizes[t] + node_w[node] <= cap:
                        part[node] = t
                        sizes[t] += node_w[node]
                        sizes[p] -= node_w[node]
                        moved = True
                        break
                if sizes[p] <= cap:
                    break
            if not moved:
                # fallback: dump into the globally lightest part
                node = order[0]
                t = int(np.argmin(sizes))
                part[node] = t
                sizes[t] += node_w[node]
                sizes[p] -= node_w[node]
    return part


def partition_graph(
    indptr: np.ndarray,
    indices: np.ndarray,
    edge_weights: Optional[np.ndarray],
    k: int,
    eps: float = 0.05,
    node_weights: Optional[np.ndarray] = None,
    seed: int = 555,
    coarse_target_per_part: int = 64,
    refine_rounds: int = 12,
) -> np.ndarray:
    """Multilevel eps-balanced k-way partition of a symmetric CSR graph.

    Drop-in role of ``PartitionGraphWithKaMinPar`` (partitioning.cpp:172-199).
    Returns [n] int32 part ids with max part weight <= (1+eps)*ceil(W/k).
    """
    n = len(indptr) - 1
    if n == 0:
        return np.zeros(0, np.int32)
    if n <= k:
        return np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    v = indices.astype(np.int64)
    w = (
        np.ones(len(v), np.float32)
        if edge_weights is None
        else np.asarray(edge_weights, np.float32)
    )
    node_w = (
        np.ones(n, np.float32)
        if node_weights is None
        else np.asarray(node_weights, np.float32)
    )
    total_w = float(node_w.sum())
    cap = (1.0 + eps) * np.ceil(total_w / k)

    # -- coarsen ------------------------------------------------------------
    # each entry: (mapping fine->coarse, fine-level edges + node weights)
    levels: list = []
    cu, cv, cw, cnw = u, v, w, node_w
    coarse_target = max(coarse_target_per_part * k, 256)
    max_node_w = cap / 4  # keep coarse nodes refinable
    while len(cnw) > coarse_target:
        mapping, nu, nv, nw_, nnw = coarsen_once(cu, cv, cw, cnw, max_node_w, rng)
        if len(nnw) >= len(cnw) * 0.98 or len(nu) == 0:
            break  # matching stalled (e.g. star graphs)
        levels.append((mapping, cu, cv, cw, cnw))
        cu, cv, cw, cnw = nu, nv, nw_, nnw

    # -- initial partition on coarsest level ---------------------------------
    part = _initial_partition(cu, cv, cw, cnw, k, cap, rng)
    part = refine(cu, cv, cw, part, cnw, k, cap, rounds=refine_rounds, seed=seed)
    part = _force_balance(cu, cv, cw, part, cnw, k, cap)

    # -- uncoarsen + refine ----------------------------------------------------
    for mapping, fu, fv, fw, fnw in reversed(levels):
        part = part[mapping]
        part = refine(fu, fv, fw, part, fnw, k, cap, rounds=refine_rounds,
                      seed=seed + len(fnw))
        part = _force_balance(fu, fv, fw, part, fnw, k, cap)
    return part.astype(np.int32)
