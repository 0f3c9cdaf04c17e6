"""kNN-graph layer: exact oracle + approximate leader-sketching builder.

Replacement for the reference's ``src/knn_graph.h``.
"""

from gpann_tpu.graph.knn import (
    ApproximateKNNGraphBuilder,
    build_exact_knn_graph,
    graph_recall,
    symmetrize_to_csr,
)

__all__ = [k for k in dir() if not k.startswith("_")]
