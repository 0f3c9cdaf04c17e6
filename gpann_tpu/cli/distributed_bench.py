"""DistributedBench CLI — measured multi-device query benchmark.

The accelerator realization of the reference's MPI prototype
(``distributed_bench.cpp`` + ``src/distributed_query_benchmark.h``, C16 —
disabled and non-compiling in the reference's build, SURVEY.md §5.8). Here it
is real: shards live across the device mesh (``gpann_tpu.dist``), queries are
routed on every device, candidate lists merge over device collectives, and the
QPS is *measured*, not simulated.

Single-host it uses all local devices; multi-host, launch one process per
host with the usual coordinator env and pass --distributed to call
``jax.distributed.initialize()`` first (reference striping of queries across
ranks, ``distributed_bench.cpp:39-42``, is replaced by the dp mesh axis).

Usage:
    python -m gpann_tpu.cli.distributed_bench \
        <points.fbin> <queries.fbin> <k> <clusters_file> <nprobes> \
        [metric] [--distributed]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from gpann_tpu.core import read_clusters, read_points
from gpann_tpu.core.timer import time_fn


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--distributed" in argv:
        argv.remove("--distributed")
        import jax

        jax.distributed.initialize()
    if len(argv) < 5:
        print(__doc__)
        return 2
    point_file, query_file, k_str, part_file, nprobes_str = argv[:5]
    metric = argv[5] if len(argv) > 5 else "l2"
    k, nprobes = int(k_str), int(nprobes_str)

    import jax
    import jax.numpy as jnp

    from gpann_tpu.dist import (
        DistributedIVF,
        DistributedServingEngine,
        shard_mesh,
    )
    from gpann_tpu.route import centroid_router

    points = read_points(point_file)
    queries = read_points(query_file)
    clusters = read_clusters(part_file)
    ndev = len(jax.devices())
    dp = 2 if ndev % 2 == 0 and ndev >= 4 else 1
    mesh = shard_mesh(dp=dp)
    print(f"{ndev} devices; {len(clusters)} shards; mesh {dict(mesh.shape)}")

    t0 = time.time()
    router = centroid_router(points, clusters, metric=metric)
    engine = DistributedServingEngine(
        points, clusters, np.asarray(router.points), router.labels_np,
        mesh=mesh, metric=metric,
    )
    print(f"index built in {time.time() - t0:.1f}s")

    m = len(queries)
    microbatch = max(1, min(128, m // max(dp, 1)))

    # fused path: routing happens on-device inside the mesh program
    d, i = engine.serve(queries, k, nprobes, microbatch=microbatch)
    print(f"fused serve warm: top1 id of q0 = {i[0, 0]}")

    # measured multi-batch pipelined QPS: dispatch batches back-to-back,
    # chain results on device, one final readback (the reference pipelines
    # doubling batches for the same reason, distributed_query_benchmark.h:148)
    quantum = dp * microbatch
    mq = -(-m // quantum) * quantum
    qp = np.zeros((mq, queries.shape[1]), np.float32)
    qp[:m] = queries
    q_dev = jnp.asarray(qp)
    reps = 10
    t0 = time.time()
    acc = None
    for _ in range(reps):
        d0, _ = engine.serve_device(q_dev, k, nprobes, microbatch=microbatch)
        acc = d0 if acc is None else acc + d0
    float(jnp.sum(jnp.where(jnp.isfinite(acc), acc, 0.0)))  # sync
    lat = (time.time() - t0) / reps
    qps = mq / lat
    print(f"fused nprobes={nprobes}: {mq} queries in {lat*1e3:.1f} ms -> "
          f"{qps:.0f} QPS ({qps/ndev:.0f} QPS/device)")

    # unfused reference point: host-computed probes + collective search
    index = DistributedIVF(points, clusters, mesh=mesh, metric=metric)
    probes = router.query(queries, rule="min_dist")[:, :nprobes]
    lat, (d, i) = time_fn(index.search_probed, queries, probes, k, reps=5)
    print(f"unfused nprobes={nprobes}: {m} queries in {lat*1e3:.1f} ms -> "
          f"{m / lat:.0f} QPS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
