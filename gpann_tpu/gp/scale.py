"""GP at scale: subsample graph partitioning + capacity stream-assignment.

The reference's flagship GP pipeline (kNN graph -> balanced graph partition,
``src/partitioning.cpp:251-264``) reaches 1B points via Pyramid-style
subsampling: partition a subsample's aggregates, then assign every point to
the partition of its nearest aggregate under a capacity constraint with
retry rounds (``src/partitioning.cpp:266-356``); OurPyramid runs the graph
partitioner on coarse representatives (``partitioning.cpp:509-552``). This
module composes those two ideas accelerator-first:

1. **Subsample** ``num_subsample`` points (in host RAM).
2. **GP on the subsample**: approximate kNN graph (leader sketching on the
   matmul, :mod:`gpann_tpu.graph.knn`) + balanced LP partition
   (:mod:`gpann_tpu.gp.lp`) — the flagship method itself, at a size the
   in-RAM builder handles.
3. **Aggregate within parts**: per-part k-means on the subsample members
   (budget split proportional to part size) yields ``num_aggregate``
   representatives that respect the graph-partition boundary — unlike
   Pyramid's pre-partition aggregates, these can never merge two GP parts
   into one Voronoi cell.
4. **Stream-assign all points** to the part of their nearest open aggregate
   under capacity ``(1+eps)*ceil(n/k)`` with retry rounds
   (:func:`gpann_tpu.cluster.streaming.capacity_stream_assign`): one chunked
   pass over the (memmap) base, masked-argmin on device, 8 B/point readback.

The result is the GP partition extended to datasets far beyond both host RAM
comfort and device HBM, with the same balance guarantee as the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gpann_tpu.cluster.streaming import capacity_stream_assign
from gpann_tpu.core.distances import Metric
from gpann_tpu.core.partition import Partition


def gp_aggregates(
    sample: np.ndarray,
    sub_part: np.ndarray,
    k: int,
    num_aggregate: int,
    metric: Metric = "l2",
    seed: int = 555,
    rounds: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-part k-means representatives of a partitioned sample.

    The aggregate budget is split across parts proportionally to part size
    (>= 1 each, mirroring the tree router's proportional budget split,
    ``kmeans_tree_router.cpp:9-33``). Returns (aggregates [a, d],
    labels [a]) with ``labels[i]`` the part whose sample members produced
    aggregate ``i``.
    """
    from gpann_tpu.cluster.kmeans import kmeans

    sizes = np.bincount(sub_part, minlength=k).astype(np.float64)
    quota = np.maximum(
        1, np.round(num_aggregate * sizes / max(sizes.sum(), 1)).astype(int)
    )
    reps, labels = [], []
    for p in range(k):
        members = np.nonzero(sub_part == p)[0]
        if len(members) == 0:
            continue
        kp = int(min(quota[p], len(members)))
        if kp >= len(members):
            cents = sample[members]
        else:
            cents, _ = kmeans(sample[members], k=kp, metric=metric,
                              rounds=rounds, seed=seed + p)
            # drop empty-cluster duplicates kmeans may leave behind
            cents = np.unique(cents, axis=0)
        reps.append(np.asarray(cents, np.float32))
        labels.append(np.full(len(cents), p, np.int64))
    return np.concatenate(reps, axis=0), np.concatenate(labels)


def subsample_gp_aggregates(
    points,                     # array-like / np.memmap [n, d]
    k: int,
    eps: float = 0.05,
    metric: Metric = "l2",
    seed: int = 555,
    num_subsample: int = 2_000_000,
    num_aggregate: int = 4096,
    degree: int = 10,
    strong: bool = False,
):
    """Steps 1-3 of the scaled GP pipeline (module docstring): subsample ->
    GP on the subsample's kNN graph -> per-part aggregates. Returns
    ``(aggregates, agg_labels, sample_idx, sub_part)``; feed the aggregates
    to :func:`~gpann_tpu.cluster.streaming.capacity_stream_assign` (or the
    fused relayout assigner,
    :func:`~gpann_tpu.search.relayout.capacity_assign_to_store`).

    A base advertising ``iid_rows`` (``eval/synth.py::VirtualPoints``) is
    sampled by contiguous prefix — distributionally identical for
    exchangeable rows, and O(ns) instead of a full regeneration pass.
    """
    from gpann_tpu.gp.partitioning import partition_dense_graph
    from gpann_tpu.graph.knn import ApproximateKNNGraphBuilder

    n = points.shape[0]
    rng = np.random.default_rng(seed)
    ns = min(num_subsample, n)
    if ns == n:
        sample_idx = np.arange(n)
        sample = np.asarray(points, np.float32)
    elif getattr(points, "iid_rows", False):
        sample_idx = np.arange(ns)
        sample = np.asarray(points[:ns], np.float32)
    else:
        sample_idx = np.sort(rng.choice(n, size=ns, replace=False))
        sample = np.asarray(points[sample_idx], np.float32)

    builder = ApproximateKNNGraphBuilder(metric=metric, seed=seed,
                                         strong=strong)
    graph = builder.build(sample, degree)
    sub_part = partition_dense_graph(graph, k, eps, seed=seed)
    del graph

    aggregates, agg_labels = gp_aggregates(
        sample, sub_part, k, num_aggregate, metric=metric, seed=seed
    )
    return aggregates, agg_labels, sample_idx, sub_part


def subsample_gp_partition(
    points,                     # array-like / np.memmap [n, d]
    k: int,
    eps: float = 0.05,
    metric: Metric = "l2",
    seed: int = 555,
    num_subsample: int = 2_000_000,
    num_aggregate: int = 4096,
    degree: int = 10,
    strong: bool = False,
    chunk_rows: int = 1 << 20,
    return_artifacts: bool = False,
):
    """GP partition of an arbitrarily large (memmap) base.

    Balance guarantee: ``max part size <= (1+eps)*ceil(n/k)`` — identical to
    the reference's Pyramid capacity rule (``partitioning.cpp:303``).

    ``return_artifacts=True`` also returns ``(aggregates, agg_labels,
    sample_idx, sub_part)`` for router training / diagnostics.
    """
    aggregates, agg_labels, sample_idx, sub_part = subsample_gp_aggregates(
        points, k, eps=eps, metric=metric, seed=seed,
        num_subsample=num_subsample, num_aggregate=num_aggregate,
        degree=degree, strong=strong,
    )
    part = capacity_stream_assign(
        points, aggregates, agg_labels, k, eps=eps, chunk_rows=chunk_rows,
        metric=metric,
    )
    if return_artifacts:
        return part, (aggregates, agg_labels, sample_idx, sub_part)
    return part
