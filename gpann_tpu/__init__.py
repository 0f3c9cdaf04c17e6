"""gpann_tpu — a GPU-accelerated (JAX/XLA/Pallas) framework with the
capabilities of gp-ann (larsgottesbueren/gp-ann): billion-scale partitioned
approximate nearest-neighbor search.

Layer map (mirrors reference SURVEY.md §1, re-designed accelerator-first):

- ``core``    — vector I/O, distance matmul kernels, top-k, segment ops, timers.
- ``cluster`` — Lloyd / balanced / hierarchical k-means.
- ``graph``   — exact + approximate kNN-graph construction.
- ``gp``      — balanced & overlapping graph partitioning (KaMinPar replacement).
- ``route``   — k-means-tree router + flat routing-point router (4 probe rules).
- ``search``  — shard-major IVF layout + fused distance-scan/top-k shard search.
- ``eval``    — ground truth, recall, oracle recall, QPS simulator + Pareto.
- ``dist``    — shard mesh, multi-device query scatter / top-k merge collectives.
- ``cli``     — command-line drivers mirroring the reference binaries.
"""

__version__ = "0.1.0"


import os

# the checkout this package runs from; caches live inside it, git-ignored
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def artifact_dir() -> str:
    """Directory for cached data and build artifacts (datasets, partitions,
    ground truth, shard stores): ``GPANN_CACHE_DIR`` if set, else
    ``<checkout>/.bench_cache``. Created on first use."""
    path = os.environ.get("GPANN_CACHE_DIR") or os.path.join(
        CHECKOUT, ".bench_cache")
    os.makedirs(path, exist_ok=True)
    return path


def _compilation_cache_dir() -> str | None:
    """Where compiled programs persist across processes: JAX's own
    ``JAX_COMPILATION_CACHE_DIR`` when set (None: nothing to set here), else
    a fixed path inside the checkout. The path is part of the cache's key,
    so it must not move between runs."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def _enable_compilation_cache() -> None:
    path = _compilation_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)


_enable_compilation_cache()
