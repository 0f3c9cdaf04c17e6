"""The bin-top-2 kernel as compiled for the card (Triton route, no interpret
mode) against the plain references. Skips without an NVIDIA GPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpann_tpu.core.distances import topk_neighbors
from gpann_tpu.eval.synth import blobs
from gpann_tpu.search.pallas_scan import (
    TILE,
    bin_top2_blocks,
    bin_top2_reference,
    fused_topk,
    pad_base_for_scan,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def data():
    base, qs = blobs(2 * TILE, 96, 256, seed=9)
    padded, _ = pad_base_for_scan(base)
    return base, padded, qs, 2 * TILE - 77


def test_compiled_kernel_matches_reference(gpu, data):
    """Bin minima within rtol 1e-2 of the HIGHEST-precision reference: the
    kernel's dot runs in TF32 (~2^-11 relative input rounding)."""
    base, padded, qs, n = data
    qp = jnp.pad(jnp.asarray(qs), ((0, 0), (0, padded.shape[1] - 96)))
    mins, _ = bin_top2_blocks(qp, jnp.asarray(padded),
                              jnp.zeros(1, jnp.int32),
                              jnp.full(1, n, jnp.int32),
                              qb=len(qs), cap=padded.shape[0])
    want, _ = bin_top2_reference(qp, jnp.asarray(padded), n)
    mins, want = np.asarray(mins), np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(mins) == fin).all()
    np.testing.assert_allclose(mins[fin], want[fin], rtol=1e-2)


def test_compiled_fused_topk_recall(gpu, data):
    base, padded, qs, n = data
    d, i = fused_topk(jnp.asarray(qs), jnp.asarray(padded), n, 10)
    _, xi = topk_neighbors(jnp.asarray(qs), jnp.asarray(base[:n]), 10,
                           precision=jax.lax.Precision.HIGHEST)
    i, xi = np.asarray(i), np.asarray(xi)
    recall = np.mean([len(np.intersect1d(i[r], xi[r]))
                      for r in range(len(qs))]) / 10
    assert recall >= 0.99, recall
    exact = ((qs[:, None, :].astype(np.float64) - base[i]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(d), exact, rtol=1e-5)
