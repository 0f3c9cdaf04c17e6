"""Multi-device distributed query engine over a shard mesh.

This is the Accelerator realization of the reference's *prototype* MPI
distributed benchmark (``src/distributed_query_benchmark.h``,
``distributed_bench.cpp`` — disabled in its build, see SURVEY.md §5.8).
Design per SURVEY.md §5.8:

- Topology: shards are distributed over a ``Mesh(("shard",))`` axis — one or
  more IVF shards resident per device (the reference's 1 shard = 1 host,
  ``route_search_combination.cpp:148-152``). An optional ``("dp",)`` axis
  splits the query batch.
- Query flow: queries are replicated over the shard axis (they are small);
  each device scans only its resident shards, masked by each query's probe
  list; per-device top-k candidate lists are merged with one ``all_gather``
  over the shard axis (fixed [ndev, m, k] shape — k is small) — replacing the
  reference's float-stream Request/Response MPI protocol
  (``distributed_query_benchmark.h:107-135``) with dense device collectives.
- Multi-host: the same code runs under ``jax.distributed.initialize`` with a
  global mesh; no code changes (the mesh covers all processes' devices).

The per-device compute reuses the single-device fused scan+rescore kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpann_tpu.core.distances import Metric, default_precision, sq_norms
from gpann_tpu.core.partition import Clusters


def shard_mesh(devices=None, dp: int = 1) -> Mesh:
    """Build a ("dp", "shard") mesh over the given (default: all) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n % dp != 0:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    return Mesh(devices.reshape(dp, n // dp), ("dp", "shard"))


def _local_scan(queries, probes, blocks, sizes, ids, shard_offset, k: int,
                metric: Metric, precision, rescore: bool):
    """Scan the device-resident shards; queries masked by probe membership.

    blocks [s_local, cap, d]; returns merged (dists [m,k], ids [m,k])."""
    from gpann_tpu.search.ivf import _exact_rescore, _scan_k

    m = queries.shape[0]
    q_sq = sq_norms(queries) if metric == "l2" else None

    def body(carry, inp):
        best_d, best_i = carry
        local_idx, block, size, bids = inp
        global_shard = shard_offset + local_idx
        dots = jnp.dot(queries, block.T, preferred_element_type=jnp.float32,
                       precision=precision)
        if metric == "mips":
            dm = 1.0 - dots
        else:
            dm = q_sq[:, None] + sq_norms(block)[None, :] - 2.0 * dots
        cap = block.shape[0]
        valid = jnp.arange(cap) < size
        probing = jnp.any(probes == global_shard, axis=1)
        dm = jnp.where(valid[None, :] & probing[:, None], dm, jnp.inf)
        neg, pos = jax.lax.top_k(-dm, _scan_k(k, cap, rescore))
        if rescore:
            d, pos2 = _exact_rescore(queries, block, -neg, pos, k, metric)
            i = bids[pos2]
        else:
            d, i = -neg[:, :k], bids[pos[:, :k]]
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, i], axis=1)
        nneg, npos = jax.lax.top_k(-cat_d, k)
        return (-nneg, jnp.take_along_axis(cat_i, npos, axis=1)), None

    s_local = blocks.shape[0]
    init = (jnp.full((m, k), jnp.inf, jnp.float32),
            jnp.full((m, k), -1, jnp.int32))
    (d, i), _ = jax.lax.scan(
        body, init,
        (jnp.arange(s_local, dtype=jnp.int32), blocks, sizes, ids),
    )
    return d, i


class DistributedIVF:
    """IVF shards resident across a device mesh; collective query merge."""

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        mesh: Optional[Mesh] = None,
        metric: Metric = "l2",
        pad_multiple: int = 128,
        precision=None,
        rescore: bool = True,
    ) -> None:
        self.mesh = mesh if mesh is not None else shard_mesh()
        self.metric: Metric = metric
        self.precision = default_precision() if precision is None else precision
        self.rescore = rescore
        n_shard_devs = self.mesh.shape["shard"]

        s = len(clusters)
        # pad shard count to a multiple of the shard axis (empty shards)
        s_pad = -(-s // n_shard_devs) * n_shard_devs
        self.num_shards = s
        sizes = np.zeros(s_pad, np.int32)
        sizes[:s] = [len(c) for c in clusters]
        cap = -(-max(int(sizes.max()), 1) // pad_multiple) * pad_multiple
        self.capacity = cap
        d = points.shape[1]
        blocks = np.zeros((s_pad, cap, d), np.float32)
        ids = np.full((s_pad, cap), -1, np.int32)
        for b, members in enumerate(clusters):
            members = np.asarray(members, np.int64)
            blocks[b, : len(members)] = points[members]
            ids[b, : len(members)] = members

        # make_array_from_callback materializes only each process's
        # addressable shards — this is what makes the same code work
        # multi-host under jax.distributed (each host holds its own shards,
        # like the reference's per-rank LoadShardPointSet,
        # distributed_query_benchmark.h:48-84)
        def _put(arr, spec):
            sharding = NamedSharding(self.mesh, spec)
            return jax.make_array_from_callback(
                arr.shape, sharding, lambda idx: arr[idx]
            )

        self.shard_points = _put(blocks, P("shard", None, None))
        self.shard_sizes = _put(sizes, P("shard"))
        self.shard_ids = _put(ids, P("shard", None))
        self._search_cache: dict = {}

    def _build_search(self, k: int):
        mesh = self.mesh
        metric, precision, rescore = self.metric, self.precision, self.rescore
        s_local = self.shard_points.shape[0] // mesh.shape["shard"]

        def search(queries, probes, blocks, sizes, ids):
            # queries/probes split over dp, replicated over shard;
            # blocks/sizes/ids split over shard, replicated over dp.
            shard_offset = jax.lax.axis_index("shard") * s_local
            d, i = _local_scan(
                queries, probes, blocks, sizes, ids, shard_offset, k,
                metric, precision, rescore,
            )
            # merge candidate lists across the shard axis (all-gather)
            all_d = jax.lax.all_gather(d, "shard", axis=0)  # [ndev, m, k]
            all_i = jax.lax.all_gather(i, "shard", axis=0)
            m = d.shape[0]
            cat_d = jnp.moveaxis(all_d, 0, 1).reshape(m, -1)
            cat_i = jnp.moveaxis(all_i, 0, 1).reshape(m, -1)
            neg, pos = jax.lax.top_k(-cat_d, k)
            return -neg, jnp.take_along_axis(cat_i, pos, axis=1)

        shard_map_fn = jax.shard_map(
            search,
            mesh=mesh,
            in_specs=(
                P("dp", None),          # queries
                P("dp", None),          # probes
                P("shard", None, None),  # blocks
                P("shard"),              # sizes
                P("shard", None),        # ids
            ),
            out_specs=(P("dp", None), P("dp", None)),
            check_vma=False,
        )
        return jax.jit(shard_map_fn)

    def search_probed(
        self, queries: np.ndarray, probes: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Distributed probed search. probes [m, p] global shard ids (-1 pad).

        Query batches not divisible by the dp axis are padded transparently.
        """
        if k not in self._search_cache:
            self._search_cache[k] = self._build_search(k)
        m = len(queries)
        dp = self.mesh.shape["dp"]
        pad = (-m) % dp
        if pad:
            queries = np.concatenate(
                [np.asarray(queries, np.float32),
                 np.zeros((pad, queries.shape[1]), np.float32)]
            )
            probes = np.concatenate(
                [np.asarray(probes, np.int32),
                 np.full((pad, probes.shape[1]), -1, np.int32)]
            )
        d, i = self._search_cache[k](
            jnp.asarray(queries, jnp.float32),
            jnp.asarray(probes, jnp.int32),
            self.shard_points,
            self.shard_sizes,
            self.shard_ids,
        )
        return np.asarray(d)[:m], np.asarray(i)[:m]


class DistributedServingEngine(DistributedIVF):
    """Fused distributed serving: route + scan + merge in ONE mesh program.

    The reference's ranks route their own query stripe locally and pipeline
    doubling batches to overlap routing with remote search
    (``distributed_query_benchmark.h:148-180``). Accelerator equivalent:

    - the routing points (small) are replicated to every device; each device
      routes its dp-slice of queries on-device with the same
      :func:`gpann_tpu.search.serve._probe_rank` fold as the single-device
      engine (all four hnsw_router.h rules) — zero communication, exactly
      "ranks route locally";
    - a ``lax.scan`` over fixed query microbatches replaces the doubling
      batches: each step's ``all_gather`` merge can overlap the next
      step's local scan under XLA's async collectives;
    - one program: no host round-trip between routing and search (the
      reference ships query vectors over MPI; here the probe decision never
      leaves the device).
    """

    def __init__(
        self,
        points: np.ndarray,
        clusters: Clusters,
        routing_points: np.ndarray,
        routing_labels: np.ndarray,
        mesh: Optional[Mesh] = None,
        metric: Metric = "l2",
        pad_multiple: int = 128,
        precision=None,
        rescore: bool = True,
        voting_impl: str = "exact",
    ) -> None:
        super().__init__(points, clusters, mesh=mesh, metric=metric,
                         pad_multiple=pad_multiple, precision=precision,
                         rescore=rescore)
        self.voting_impl = voting_impl
        rp = np.asarray(routing_points, np.float32)
        rsq = (rp.astype(np.float64) ** 2).sum(1).astype(np.float32)
        rep = NamedSharding(self.mesh, P())
        self.router_points = jax.device_put(rp, rep)
        self.router_labels = jax.device_put(
            np.asarray(routing_labels, np.int32), rep
        )
        self.router_sq = jax.device_put(rsq, rep)
        self._serve_cache: dict = {}

    def _build_serve(self, k: int, nprobes: int, voting_t: int, rule: str,
                     spann_eps: float, microbatch: int):
        from gpann_tpu.search.serve import _probe_rank

        mesh = self.mesh
        metric, precision, rescore = self.metric, self.precision, self.rescore
        voting_impl = self.voting_impl
        s = self.num_shards
        s_local = self.shard_points.shape[0] // mesh.shape["shard"]

        def serve(queries, blocks, sizes, ids, rp, rl, rsq):
            m_local, d_dim = queries.shape
            shard_offset = jax.lax.axis_index("shard") * s_local
            n_mb = m_local // microbatch

            def mb_body(carry, q_mb):
                probes = _probe_rank(
                    q_mb, rp, rl, rsq, s=s, voting_t=voting_t, rule=rule,
                    spann_eps=spann_eps, nprobes=nprobes, metric=metric,
                    precision=precision, voting_impl=voting_impl,
                )
                d, i = _local_scan(q_mb, probes, blocks, sizes, ids,
                                   shard_offset, k, metric, precision, rescore)
                all_d = jax.lax.all_gather(d, "shard", axis=0)
                all_i = jax.lax.all_gather(i, "shard", axis=0)
                mb = d.shape[0]
                cat_d = jnp.moveaxis(all_d, 0, 1).reshape(mb, -1)
                cat_i = jnp.moveaxis(all_i, 0, 1).reshape(mb, -1)
                neg, pos = jax.lax.top_k(-cat_d, k)
                return carry, (-neg, jnp.take_along_axis(cat_i, pos, axis=1))

            _, (d, i) = jax.lax.scan(
                mb_body, None, queries.reshape(n_mb, microbatch, d_dim)
            )
            return d.reshape(m_local, k), i.reshape(m_local, k)

        shard_map_fn = jax.shard_map(
            serve,
            mesh=mesh,
            in_specs=(
                P("dp", None),           # queries
                P("shard", None, None),  # blocks
                P("shard"),              # sizes
                P("shard", None),        # ids
                P(), P(), P(),           # routing points/labels/sq: replicated
            ),
            out_specs=(P("dp", None), P("dp", None)),
            check_vma=False,
        )
        return jax.jit(shard_map_fn)

    def serve(
        self,
        queries: np.ndarray,
        k: int,
        nprobes: int,
        voting_t: int = 60,
        rule: str = "min_dist",
        spann_eps: float = 0.6,
        microbatch: int = 128,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Routed distributed search; pads the batch to dp*microbatch."""
        key = (k, nprobes, voting_t, rule, spann_eps, microbatch)
        if key not in self._serve_cache:
            self._serve_cache[key] = self._build_serve(
                k, nprobes, voting_t, rule, spann_eps, microbatch
            )
        m = len(queries)
        dp = self.mesh.shape["dp"]
        quantum = dp * microbatch
        pad = (-m) % quantum
        queries = np.asarray(queries, np.float32)
        if pad:
            queries = np.concatenate(
                [queries, np.zeros((pad, queries.shape[1]), np.float32)]
            )
        d, i = self._serve_cache[key](
            jnp.asarray(queries),
            self.shard_points,
            self.shard_sizes,
            self.shard_ids,
            self.router_points,
            self.router_labels,
            self.router_sq,
        )
        return np.asarray(d)[:m], np.asarray(i)[:m]

    def serve_device(self, queries_dev, k: int, nprobes: int,
                     voting_t: int = 60, rule: str = "min_dist",
                     spann_eps: float = 0.6, microbatch: int = 128):
        """Device-resident variant (no padding, no readback) for pipelined
        throughput loops; ``queries_dev`` length must divide dp*microbatch."""
        key = (k, nprobes, voting_t, rule, spann_eps, microbatch)
        if key not in self._serve_cache:
            self._serve_cache[key] = self._build_serve(
                k, nprobes, voting_t, rule, spann_eps, microbatch
            )
        return self._serve_cache[key](
            queries_dev,
            self.shard_points,
            self.shard_sizes,
            self.shard_ids,
            self.router_points,
            self.router_labels,
            self.router_sq,
        )


# ---------------------------------------------------------------------------
# Sharded index-build step (the framework's "training step"): one Lloyd
# round with points sharded over dp and centroid stats psum-reduced.
# ---------------------------------------------------------------------------


def sharded_lloyd_round(mesh: Mesh, k: int, metric: Metric = "l2"):
    """Returns a jitted fn(points, centroids) -> (centroids', assignment)
    with points sharded over the dp axis; the segment sums ride psum."""

    def step(points, centroids):
        dots = jnp.dot(points, centroids.T, preferred_element_type=jnp.float32,
                       precision=default_precision())
        if metric == "mips":
            dm = 1.0 - dots
        else:
            dm = (
                sq_norms(points)[:, None] + sq_norms(centroids)[None, :]
                - 2.0 * dots
            )
        assignment = jnp.argmin(dm, axis=1)
        sums = jax.ops.segment_sum(points, assignment, num_segments=k)
        counts = jax.ops.segment_sum(
            jnp.ones(points.shape[0], jnp.float32), assignment, num_segments=k
        )
        sums = jax.lax.psum(sums, ("dp", "shard"))
        counts = jax.lax.psum(counts, ("dp", "shard"))
        new_centroids = jnp.where(
            counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None],
            centroids,
        )
        return new_centroids, assignment.astype(jnp.int32)

    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(("dp", "shard"), None), P(None, None)),
        out_specs=(P(None, None), P(("dp", "shard"))),
        check_vma=False,
    )
    return jax.jit(fn)
