"""Shared bootstrap for the 8M hard-mixture artifact cache.

gp_fidelity_8m / qa_ogp_8m consume the GT + subsample-GP partition + router
that hard_serve_bench.py computes (~50 min to rebuild), so the compact
artifact ships in the repo (exp_artifacts/hardserve_8m_cache.npz, same
discipline as bench.py); this helper materializes it into the artifact
cache path so each experiment can run standalone in any order.
"""

import os

import numpy as np


def ensure_hardserve(cache_path: str) -> bool:
    """Seed ``cache_path`` from the repo artifact if absent. Returns True
    when the cache exists afterwards."""
    if os.path.exists(cache_path):
        return True
    if os.environ.get("GPANN_SMOKE"):
        # smoke caches are tiny-shape; the 8M repo artifact would poison them
        return False
    repo_art = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "exp_artifacts", "hardserve_8m_cache.npz")
    if not os.path.exists(repo_art):
        return False
    art = dict(np.load(repo_art))
    art["assign"] = art["assign"].astype(np.int32)
    art["gt_ids"] = art["gt_ids"].astype(np.int64)
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    np.savez(cache_path, **art)
    return True
