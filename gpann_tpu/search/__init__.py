"""In-shard search layer: shard-major IVF + fused distance-scan/top-k.

Replacement for the reference's L4b (``src/inverted_index.h``,
``src/inverted_index_hnsw.h``, ``src/shard_searches.cpp``).
"""

from gpann_tpu.search.ivf import (
    IVFIndex,
    hits_per_shard,
    merge_shard_topk,
)

__all__ = [k for k in dir() if not k.startswith("_")]
