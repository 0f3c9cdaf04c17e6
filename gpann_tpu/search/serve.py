"""Fused single-device serving engine: route + group + scan + merge in one jit.

Production query path (the role of the reference's per-query serving loop,
``small_scale_queries.cpp:146-188``, redesigned for the accelerator). No
intermediate crosses back to the host, so the WHOLE query pipeline is one
compiled program:

1. **Route**: distance matmul against the routing points, top-T vote fold
   (scatter-min / scatter-add), probe ranking — all on device. The four probe
   rules of ``hnsw_router.h:55-104`` are supported; rules that cut the probe
   list short (Pyramid/SPANN) route those slots to a dummy shard whose size
   is 0, so they also cut compute.
2. **Group**: the (query, shard) probe pairs are sorted by shard and packed
   into fixed ``[query_block]`` blocks with static shapes (worst-case
   padding: ceil(m*nprobes/qb) + num_shards blocks).
3. **Scan**: either one Pallas kernel launch over the whole block list
   (``scan_mode="binned"``, :mod:`gpann_tpu.search.pallas_scan`) or one
   ``lax.scan`` over query blocks, each step running the HIGH-precision
   distance matmul + top-k + exact rescore on its shard's resident block.
4. **Merge**: results scattered back to a per-query candidate table, final
   top-k on device. Only the [m, k] result crosses back to host.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpann_tpu.core.distances import Metric, default_precision, sq_norms
from gpann_tpu.core.partition import Clusters
from gpann_tpu.search.ivf import _exact_rescore, _round_up, _scan_k


def _probe_rank(queries, router_points, router_labels, router_sq, *,
                s, voting_t, rule, spann_eps, nprobes, metric, precision,
                voting_impl, router_n_valid=None, interpret=False):
    """Probe list [m, nprobes] under the reference's vote semantics.

    (min_dist, frequency) are folded over ONLY the top ``voting_t`` routing
    points — ``hnsw_router.h:106-119``: ``searchKnn(Q, num_voting_neighbors)``
    then per-shard min/count over that set. Slots a rule cuts short point at
    the dummy shard ``s`` (size 0, skipped by the scan).
    """
    m = queries.shape[0]
    t = min(voting_t, router_points.shape[0]
            if router_n_valid is None else router_n_valid)
    if voting_impl == "binned":
        # the scan kernel as the routing matmul: TF32 bin-top-2 candidate
        # selection + exact f32 rescore of ~t candidates. The vote set only
        # needs approximate MEMBERSHIP (the reference's vote set is
        # approximate HNSW output) while vote ORDER comes from the exact
        # rescore — same design point as the serving scan itself.
        from gpann_tpu.search.pallas_scan import fused_topk

        ndist, nidx = fused_topk(queries, router_points, router_n_valid, t,
                                 metric=metric, interpret=interpret)
        # bin-top-2 keeps <= 2 candidates per 128-column bin; if fewer than t
        # finite candidates exist the tail is +inf with arbitrary indices —
        # point those votes at the dummy shard s (OOB scatters are dropped)
        nshard = jnp.where(jnp.isfinite(ndist), router_labels[nidx], s)
    elif voting_impl == "rescore":
        # two-phase routing, same design as the serving scan: a DEFAULT
        # precision matmul only has to get a CANDIDATE set right; the t
        # votes are then picked by exact f32 distances of ~2t candidates.
        rdots = jnp.dot(queries, router_points.T,
                        preferred_element_type=jnp.float32)
        if metric == "mips":
            rdm = 1.0 - rdots
        else:
            rdm = (sq_norms(queries)[:, None] + router_sq[None, :]
                   - 2.0 * rdots)
        c = min(2 * t + 16, router_points.shape[0])
        _, cidx = jax.lax.approx_max_k(-rdm, c, recall_target=0.95)
        cand = router_points[cidx]                    # [m, c, d]
        if metric == "mips":
            exact = 1.0 - jnp.einsum(
                "md,mcd->mc", queries, cand,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            exact = jnp.sum((queries[:, None, :] - cand) ** 2, axis=-1)
        neg, sel = jax.lax.top_k(-exact, t)
        ndist = -neg
        nshard = router_labels[jnp.take_along_axis(cidx, sel, axis=1)]
    else:
        rdots = jnp.dot(queries, router_points.T,
                        preferred_element_type=jnp.float32,
                        precision=precision)
        if metric == "mips":
            rdm = 1.0 - rdots
        else:
            rdm = (sq_norms(queries)[:, None] + router_sq[None, :]
                   - 2.0 * rdots)
        if voting_impl == "approx":
            # lax.approx_max_k; on the GPU it lowers to an exact
            # selection
            neg, nidx = jax.lax.approx_max_k(-rdm, t, recall_target=0.95)
        else:
            neg, nidx = jax.lax.top_k(-rdm, t)
        ndist = -neg
        nshard = router_labels[nidx]
    row = jnp.arange(m)[:, None]
    min_d = jnp.full((m, s), jnp.inf).at[row, nshard].min(ndist)
    # unseen shards keep +inf min_dist; sort keys use a finite big number so
    # argsort is stable across backends
    dkey = jnp.where(jnp.isfinite(min_d), min_d, jnp.float32(3e38))
    if rule == "frequency":
        # reference FrequencyQuery (hnsw_router.h:87-103): ONLY the single
        # highest-frequency shard goes first (ties -> lowest index, matching
        # the strict > scan); every remaining shard is ordered purely by
        # min_dist
        freq = jnp.zeros((m, s), jnp.int32).at[row, nshard].add(1)
        top = jnp.argmax(freq, axis=1)
        key = dkey.at[jnp.arange(m), top].set(-jnp.inf)
        order = jnp.argsort(key, axis=1, stable=True)
        seen = jnp.ones((m, s), bool)  # probes all shards
    else:
        order = jnp.argsort(dkey, axis=1, stable=True)
        sorted_d = jnp.take_along_axis(min_d, order, axis=1)
        if rule == "pyramid":
            # shards seen among the voting neighbors (hnsw_router.h:66-74);
            # the reference emits them in index order but consumes the list
            # as a SET (try_increasing_num_shards=false, routes.cpp:74) — we
            # emit distance order, identical set
            seen = jnp.isfinite(sorted_d)
        elif rule == "spann":
            closest = sorted_d[:, :1]
            seen = jnp.isfinite(sorted_d) & (
                sorted_d <= (1.0 + spann_eps) * closest
            )
        else:  # min_dist probes every requested shard (:59-64)
            seen = jnp.ones_like(sorted_d, bool)
    return jnp.where(seen, order, s)[:, :nprobes].astype(jnp.int32)


class ServingEngine:
    """Resident shard blocks + routing points; fused serve() per config."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        routing_points: np.ndarray,
        routing_labels: np.ndarray,
        metric: Metric = "l2",
        pad_multiple: int = 512,
        precision=None,
        rescore: bool = True,
        scan_mode: str = "exact",
        interpret: bool = False,
        voting_impl: str = "exact",
        scan_phase2: str = "exact",
        scan_nc: int = 0,
    ) -> None:
        """``scan_mode``: "exact" = XLA top_k over the full distance tile
        (exact in-shard top-k); "binned" = the Pallas bin-top-2 kernel
        (pallas_scan.py), candidate selection + exact rescore.

        ``voting_impl``: "exact" = ``lax.top_k`` vote set; "approx" =
        ``lax.approx_max_k`` (an exact selection on the GPU); "rescore" =
        DEFAULT-precision candidate matmul + exact f32 vote rescore;
        "binned" = the bin-top-2 kernel as the routing matmul.

        ``scan_phase2``: candidate-bin selection after the binned kernel
        ("exact" `lax.top_k` / "approx" `lax.approx_max_k`); see
        :func:`gpann_tpu.search.pallas_scan.fused_topk_blocks`.

        ``scan_nc``: candidate-bin count for the binned scan (0 = the
        kernel default, max(k, 16)); more bins widen the exact-rescore
        gather.
        """
        self.metric: Metric = metric
        self.precision = default_precision() if precision is None else precision
        self.rescore = rescore
        self.scan_mode = scan_mode
        self.interpret = interpret
        self.voting_impl = voting_impl
        self.scan_phase2 = scan_phase2
        self.scan_nc = int(scan_nc)
        self.num_shards = len(clusters)
        sizes = np.asarray([len(c) for c in clusters], np.int32)
        all_ids = (
            np.concatenate([np.asarray(c) for c in clusters if len(c)])
            if any(len(c) for c in clusters) else np.empty(0, np.int32)
        )
        # overlapping clusterings can return one point from several probed
        # shards; the merge then dedups ids on device
        self.overlapping = len(np.unique(all_ids)) < len(all_ids)
        if scan_mode == "binned":
            from gpann_tpu.search.pallas_scan import TILE, padded_dim

            pad_multiple = max(pad_multiple, TILE)
        cap = _round_up(max(int(sizes.max()), 1), pad_multiple)
        self.capacity = cap
        self.max_size = int(sizes.max())
        self.dim = points.shape[1]
        # the kernel scans power-of-two feature widths; padding inside the
        # serving jit would re-copy the whole block array every dispatch
        d_pad = padded_dim(self.dim) if scan_mode == "binned" else self.dim
        blocks = np.zeros((self.num_shards, cap, d_pad), np.float32)
        ids = np.full((self.num_shards, cap), -1, np.int32)
        for b, members in enumerate(clusters):
            members = np.asarray(members, np.int64)
            blocks[b, : len(members), : self.dim] = points[members]
            ids[b, : len(members)] = members
        self.dim_pad = d_pad
        # stored FLAT [s*cap, d]: the multi-block kernel reads shard windows
        # straight out of this array (no per-block gather); the exact path
        # reshapes to [s, cap, d] inside its jit (free)
        self.shard_points = jnp.asarray(
            blocks.reshape(self.num_shards * cap, d_pad)
        )
        del blocks
        # sizes with a trailing 0 entry: dummy shard id == num_shards
        self.shard_sizes_ext = jnp.asarray(np.concatenate([sizes, [0]]))
        self.shard_ids = jnp.asarray(ids.reshape(-1))
        self.router_n_valid = len(routing_points)
        if voting_impl == "binned":
            # the bin-top-2 kernel needs row counts padded to its base-tile
            # granularity; zero rows are masked in-kernel via n_valid
            from gpann_tpu.search.pallas_scan import TILE

            rp = np.asarray(routing_points, np.float32)
            r_pad = -(-len(rp) // TILE) * TILE
            routing_points = np.zeros((r_pad, rp.shape[1]), np.float32)
            routing_points[: len(rp)] = rp
        self.router_points = jnp.asarray(routing_points, jnp.float32)
        self.router_labels = jnp.asarray(routing_labels, jnp.int32)
        # exact f32 squared norms of the routing points (computed in f64 on
        # host): the routing distance matrix must rank correctly despite the
        # reduced-precision matmul (see core/distances.py::default_precision)
        self.router_sq = jnp.asarray(
            (np.asarray(routing_points, np.float64) ** 2).sum(1).astype(
                np.float32
            )
        )
        self._fns: dict = {}

    # -- compiled pipeline -----------------------------------------------------
    def _build(self, k: int, nprobes: int, voting_t: int, rule: str,
               qb: int, spann_eps: float, curve: bool = False):
        s = self.num_shards
        metric, precision, rescore = self.metric, self.precision, self.rescore
        cap = self.capacity

        scan_mode, interpret = self.scan_mode, self.interpret
        dedup = self.overlapping
        if scan_mode == "binned":
            from gpann_tpu.search.pallas_scan import BIN

            # top-2 per bin caps the candidate pool; tiny shards can't fill
            # k candidates from bins -> fall back to the exact scan
            if 2 * (self.max_size // BIN + 1) < 4 * k:
                scan_mode = "exact"

        voting_impl = self.voting_impl
        scan_phase2 = self.scan_phase2
        scan_nc = self.scan_nc
        router_n_valid = self.router_n_valid
        dim_pad = self.dim_pad

        def pipeline(queries, shard_points, shard_sizes_ext, shard_ids,
                     router_points, router_labels, router_sq, kth=None):
            m = queries.shape[0]
            # ---- route ----
            probes = _probe_rank(
                queries, router_points, router_labels, router_sq,
                s=s, voting_t=voting_t, rule=rule, spann_eps=spann_eps,
                nprobes=nprobes, metric=metric, precision=precision,
                voting_impl=voting_impl, router_n_valid=router_n_valid,
                interpret=interpret,
            )

            # ---- group (static shapes) ----
            mn = m * nprobes
            flat_b = probes.reshape(-1)
            sort = jnp.argsort(flat_b, stable=True)
            b_sorted = flat_b[sort]
            q_sorted = (sort // nprobes).astype(jnp.int32)
            slot_sorted = (sort % nprobes).astype(jnp.int32)
            counts = jnp.zeros(s + 1, jnp.int32).at[b_sorted].add(1)
            padded = -(-counts // qb) * qb
            starts = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jnp.cumsum(padded)]
            )[:-1]
            first = jnp.searchsorted(b_sorted, jnp.arange(s + 1), side="left")
            rank = jnp.arange(mn, dtype=jnp.int32) - first[b_sorted]
            pos = starts[b_sorted] + rank
            total = -(-mn // qb) * qb + (s + 1) * qb  # static worst case
            nb = total // qb
            pair_q = jnp.full(total, m, jnp.int32).at[pos].set(q_sorted)
            # shard of each block: which padded range contains its start
            block_start = jnp.arange(nb, dtype=jnp.int32) * qb
            cum_padded = jnp.cumsum(padded)
            block_shard = jnp.searchsorted(
                cum_padded, block_start, side="right"
            ).astype(jnp.int32)
            block_shard = jnp.minimum(block_shard, s)

            # ---- scan ----
            if queries.shape[1] != dim_pad:  # zero dims change no distance
                q_scan = jnp.pad(
                    queries, ((0, 0), (0, dim_pad - queries.shape[1]))
                )
            else:
                q_scan = queries
            queries_ext = jnp.concatenate(
                [q_scan, jnp.zeros((1, dim_pad), q_scan.dtype)]
            )
            q_sq_ext = sq_norms(queries_ext) if metric == "l2" else None

            if scan_mode == "binned":
                # ONE kernel launch for the whole block list; padding
                # blocks skip in-kernel
                from gpann_tpu.search.pallas_scan import TQ, fused_topk_blocks

                tq_eff = min(qb, TQ)
                if qb % tq_eff:
                    raise ValueError(
                        f"query_block={qb} must be a multiple of {tq_eff}"
                    )
                qrows = queries_ext[pair_q]                   # [total, d]
                safe_shard = jnp.minimum(block_shard, s - 1)
                row_off = safe_shard * cap
                block_has_real = jnp.any(
                    pair_q.reshape(nb, qb) < m, axis=1
                )
                sizes_blk = jnp.where(
                    block_has_real, shard_sizes_ext[block_shard], 0
                ).astype(jnp.int32)
                bd, lpos = fused_topk_blocks(
                    qrows, shard_points, row_off, sizes_blk, k, metric,
                    qb=qb, cap=cap, tq=tq_eff, interpret=interpret,
                    phase2=scan_phase2, num_candidate_bins=scan_nc,
                )
                row_off_rows = jnp.repeat(
                    row_off, qb, total_repeat_length=total
                )
                bi = shard_ids[row_off_rows[:, None] + lpos]
                # inf-distance fillers carry clamped padded-row positions
                # that can alias REAL point ids (the clamped shard's first
                # rows); id-based recall would count them as hits. Match the
                # exact path's -1 convention.
                bi = jnp.where(jnp.isfinite(bd), bi, -1)
            else:
                sp3 = shard_points.reshape(s, cap, dim_pad)
                ids2 = shard_ids.reshape(s, cap)

                def scan_block(qidx, b):
                    qs = queries_ext[qidx]
                    blk = sp3[jnp.minimum(b, s - 1)]
                    size = shard_sizes_ext[b]  # 0 for dummy shard s
                    bids = ids2[jnp.minimum(b, s - 1)]
                    dots = jnp.dot(qs, blk.T,
                                   preferred_element_type=jnp.float32,
                                   precision=precision)
                    if metric == "mips":
                        dm = 1.0 - dots
                    else:
                        dm = (q_sq_ext[qidx][:, None] + sq_norms(blk)[None, :]
                              - 2.0 * dots)
                    valid = jnp.arange(cap) < size
                    dm = jnp.where(valid[None, :], dm, jnp.inf)
                    negk, posk = jax.lax.top_k(-dm, _scan_k(k, cap, rescore))
                    if rescore:
                        d, pos2 = _exact_rescore(qs, blk, -negk, posk, k,
                                                 metric)
                        return d, bids[pos2]
                    return -negk[:, :k], bids[posk[:, :k]]

                def body(carry, inp):
                    qidx, b = inp
                    # padding blocks (dummy shard or all-padding queries)
                    # skip the scan — the grouping's static worst case adds
                    # up to s+1 such blocks per batch
                    is_real = (shard_sizes_ext[b] > 0) & jnp.any(qidx < m)
                    d, i = jax.lax.cond(
                        is_real,
                        lambda args: scan_block(*args),
                        lambda args: (
                            jnp.full((qb, k), jnp.inf, jnp.float32),
                            jnp.full((qb, k), -1, jnp.int32),
                        ),
                        (qidx, b),
                    )
                    return carry, (d, i)

                _, (bd, bi) = jax.lax.scan(
                    body, None, (pair_q.reshape(nb, qb), block_shard)
                )
                bd = bd.reshape(total, k)
                bi = bi.reshape(total, k)

            # ---- merge ----
            out_d = jnp.full((m + 1, nprobes, k), jnp.inf).at[
                q_sorted, slot_sorted
            ].set(bd[pos])
            out_i = jnp.full((m + 1, nprobes, k), -1, jnp.int32).at[
                q_sorted, slot_sorted
            ].set(bi[pos])
            cat_d = out_d[:m].reshape(m, nprobes * k)
            cat_i = out_i[:m].reshape(m, nprobes * k)
            if dedup:
                # mask duplicate ids (keep one copy): sort by id, mark
                # equal-adjacent, scatter the mask back
                order_i = jnp.argsort(cat_i, axis=1, stable=True)
                sorted_i = jnp.take_along_axis(cat_i, order_i, axis=1)
                dup_sorted = jnp.concatenate(
                    [jnp.zeros((m, 1), bool),
                     (sorted_i[:, 1:] == sorted_i[:, :-1]) & (sorted_i[:, 1:] >= 0)],
                    axis=1,
                )
                dup = jnp.zeros_like(dup_sorted).at[
                    jnp.arange(m)[:, None], order_i
                ].set(dup_sorted)
                cat_d = jnp.where(dup, jnp.inf, cat_d)
            if curve:
                # recall@k at EVERY probe prefix 1..nprobes from this one
                # program: candidate slots are ordered by probe rank, so the
                # prefix hit counts are a cumsum over slots. Threshold recall
                # exactly as eval.recall.recall_from_candidate_distances
                # (recall.h:139-150), capped at k hits per query.
                thresh = kth + 1e-5 + 1e-4 * jnp.abs(kth)
                hit = (cat_d <= thresh[:, None]).reshape(m, nprobes, k)
                cum = jnp.cumsum(hit.sum(axis=2), axis=1)
                capped = jnp.minimum(cum, k).astype(jnp.float32)
                return capped.sum(axis=0) / (k * m)
            fneg, fpos = jax.lax.top_k(-cat_d, k)
            return -fneg, jnp.take_along_axis(cat_i, fpos, axis=1)

        return jax.jit(pipeline)

    def _build_probe(self, nprobes: int, voting_t: int, rule: str,
                     spann_eps: float):
        s = self.num_shards
        metric, precision = self.metric, self.precision
        voting_impl = self.voting_impl
        router_n_valid = self.router_n_valid
        interpret = self.interpret

        def route(queries, router_points, router_labels, router_sq):
            return _probe_rank(
                queries, router_points, router_labels, router_sq,
                s=s, voting_t=voting_t, rule=rule, spann_eps=spann_eps,
                nprobes=nprobes, metric=metric, precision=precision,
                voting_impl=voting_impl, router_n_valid=router_n_valid,
                interpret=interpret,
            )

        return jax.jit(route)

    def serve_device(
        self,
        queries,
        k: int,
        nprobes: int,
        voting_t: int = 60,
        rule: str = "min_dist",
        query_block: int = 1024,
        spann_eps: float = 0.6,
    ):
        """Like :meth:`serve` but returns device arrays — for pipelined
        serving loops that overlap result readback with the next batch's
        compute."""
        key = (k, nprobes, voting_t, rule, query_block, spann_eps)
        if key not in self._fns:
            self._fns[key] = self._build(k, nprobes, voting_t, rule,
                                         query_block, spann_eps)
        return self._fns[key](
            jnp.asarray(queries, jnp.float32),
            self.shard_points,
            self.shard_sizes_ext,
            self.shard_ids,
            self.router_points,
            self.router_labels,
            self.router_sq,
        )

    def serve_scan(
        self,
        batches,                     # [r, m, d] stack of query batches
        k: int,
        nprobes: int,
        voting_t: int = 60,
        rule: str = "min_dist",
        query_block: int = 1024,
        spann_eps: float = 0.6,
    ):
        """Serve a stack of query batches inside ONE compiled program
        (``lax.scan`` over the batch axis) — the steady-state pipelined
        serving form: one dispatch per window instead of per batch, like the
        distributed engine's microbatch scan (dist/mesh.py) and the
        reference's doubling-batch pipelining
        (distributed_query_benchmark.h:148-158).
        Returns device arrays ``([r, m, k] dists, [r, m, k] ids)``."""
        key = ("scan", k, nprobes, voting_t, rule, query_block, spann_eps)
        if key not in self._fns:
            fn = self._build(k, nprobes, voting_t, rule, query_block,
                             spann_eps)

            def scanned(qs, sp, sse, sid, rp, rl, rsq):
                def body(carry, q):
                    return carry, fn(q, sp, sse, sid, rp, rl, rsq)

                _, out = jax.lax.scan(body, 0, qs)
                return out

            self._fns[key] = jax.jit(scanned)
        return self._fns[key](
            jnp.asarray(batches, jnp.float32),
            self.shard_points,
            self.shard_sizes_ext,
            self.shard_ids,
            self.router_points,
            self.router_labels,
            self.router_sq,
        )

    def serve(
        self,
        queries,
        k: int,
        nprobes: int,
        voting_t: int = 60,
        rule: str = "min_dist",
        query_block: int = 1024,
        spann_eps: float = 0.6,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """End-to-end routed search. ``queries`` may be a device array (no
        upload cost) or NumPy (uploaded once)."""
        key = (k, nprobes, voting_t, rule, query_block, spann_eps)
        if key not in self._fns:
            self._fns[key] = self._build(k, nprobes, voting_t, rule,
                                         query_block, spann_eps)
        d, i = self._fns[key](
            jnp.asarray(queries, jnp.float32),
            self.shard_points,
            self.shard_sizes_ext,
            self.shard_ids,
            self.router_points,
            self.router_labels,
            self.router_sq,
        )
        return np.asarray(d), np.asarray(i)

    def recall_curve(
        self,
        queries,
        k: int,
        kth_dist,
        voting_t: int = 60,
        rule: str = "min_dist",
        query_block: int = 1024,
        spann_eps: float = 0.6,
    ) -> np.ndarray:
        """recall@k at EVERY probe prefix 1..num_shards from ONE compiled
        program (one compile, one [num_shards]-float readback) — the
        recompile-free way to pick the smallest nprobes hitting a recall
        target. Threshold-recall definition of recall.h:139-150 with the same
        tolerances as eval.recall.recall_from_candidate_distances."""
        key = ("curve", k, voting_t, rule, query_block, spann_eps)
        if key not in self._fns:
            self._fns[key] = self._build(k, self.num_shards, voting_t, rule,
                                         query_block, spann_eps, curve=True)
        return np.asarray(self._fns[key](
            jnp.asarray(queries, jnp.float32),
            self.shard_points,
            self.shard_sizes_ext,
            self.shard_ids,
            self.router_points,
            self.router_labels,
            self.router_sq,
            jnp.asarray(kth_dist, jnp.float32),
        ))

    def probe_order(
        self,
        queries,
        nprobes: int,
        voting_t: int = 60,
        rule: str = "min_dist",
        spann_eps: float = 0.6,
    ) -> np.ndarray:
        """The probe list [m, nprobes] the fused pipeline would scan (dummy
        shard ``num_shards`` where a rule cuts the list short) — for parity
        checks against :class:`gpann_tpu.route.FlatRouter`."""
        key = ("probe", nprobes, voting_t, rule, spann_eps)
        if key not in self._fns:
            self._fns[key] = self._build_probe(nprobes, voting_t, rule,
                                               spann_eps)
        return np.asarray(self._fns[key](
            jnp.asarray(queries, jnp.float32),
            self.router_points,
            self.router_labels,
            self.router_sq,
        ))
