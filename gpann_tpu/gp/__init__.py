"""Graph-partitioning layer: balanced multilevel partitioner (KaMinPar
replacement), flat partitioning methods, overlapping variants.

Replacement for the reference's L3 (``src/partitioning.cpp``,
``src/overlapping_partitioning.cpp``) + KaMinPar.
"""

from gpann_tpu.gp import api
from gpann_tpu.gp.lp import partition_graph
from gpann_tpu.gp.overlap import (
    make_overlapping_with_centroids,
    overlapping_graph_partitioning,
    overlapping_kmeans_partitioning_spann,
)
from gpann_tpu.gp.partitioning import (
    balanced_kmeans_partitioning,
    flat_kmeans_partitioning,
    graph_partitioning,
    hierarchical_kmeans,
    kmeans_partitioning,
    our_pyramid_partitioning,
    partition_dense_graph,
    pyramid_partitioning,
    random_partition,
    rebalancing_kmeans_partitioning,
    recursive_kmeans_partitioning,
)
from gpann_tpu.gp.scale import gp_aggregates, subsample_gp_partition

__all__ = [k for k in dir() if not k.startswith("_")]
