"""Routing layer: k-means-tree router + flat routing-point router.

Replacement for the reference's L4a (``src/kmeans_tree_router.cpp``,
``src/hnsw_router.h``, ``src/routes.cpp``).
"""

from gpann_tpu.route.flat import (
    FlatRouter,
    centroid_router,
    rank_frequency,
    rank_min_dist,
    rank_pyramid,
    rank_spann,
)
from gpann_tpu.route.kmeans_tree import KMeansTreeRouter, KMeansTreeRouterOptions

__all__ = [k for k in dir() if not k.startswith("_")]
