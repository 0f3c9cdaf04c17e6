"""Clustering layer: Lloyd / balanced / hierarchical k-means.

Replacement for the reference's ``src/kmeans.cpp`` and the
hierarchical k-means in ``src/partitioning.cpp:360-507``.
"""

from gpann_tpu.cluster.kmeans import (
    balanced_kmeans,
    kmeans,
    objective_value,
    random_sample,
    rebalance_greedy,
)
from gpann_tpu.cluster.streaming import (
    streaming_capacity_partition,
    streaming_kmeans,
)

__all__ = [k for k in dir() if not k.startswith("_")]
