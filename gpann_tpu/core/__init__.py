"""Core layer: vector I/O, distance kernels, top-k, segment ops, partitions.

Replacement for the reference's L1/L2 (``src/defs.h``, ``src/dist.cpp``,
``src/points_io.cpp``, ``src/metis_io.cpp``, ``src/topn.h``).
"""

from gpann_tpu.core.distances import (
    Metric,
    assign_closest,
    chunked_topk_neighbors,
    l2_normalize,
    pairwise_distances,
    pos_distance_offset,
    sq_norms,
    streaming_topk_neighbors,
    topk_neighbors,
)
from gpann_tpu.core.pointset import (
    read_ground_truth,
    read_header,
    read_points,
    write_ground_truth,
    write_points,
)
from gpann_tpu.core.partition import (
    Cover,
    clusters_to_cover,
    clusters_to_partition,
    cover_to_clusters,
    partition_to_clusters,
    remap_partition_ids,
)
from gpann_tpu.core.metis_io import (
    read_clusters,
    read_metis_graph,
    read_metis_partition,
    write_clusters,
    write_metis_graph,
    write_metis_partition,
)
from gpann_tpu.core.timer import Timer
from gpann_tpu.core.profiling import StageTimer, flops_of_scan, trace

__all__ = [k for k in dir() if not k.startswith("_")]
