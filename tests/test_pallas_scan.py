"""Bin-top-2 scan kernel tests: the Triton-route kernel in interpret mode on
the CPU against the plain-JAX reference and NumPy."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpann_tpu.search.pallas_scan import (
    BIN,
    LANE,
    TILE,
    WIDTH,
    bin_top2_blocks,
    bin_top2_reference,
    fused_topk,
    fused_topk_blocks,
    pad_base_for_scan,
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(555)
    base = rng.standard_normal((2 * TILE - 300, 32)).astype(np.float32)
    qs = rng.standard_normal((256, 32)).astype(np.float32)
    return qs, base


def _numpy_bins(dm):
    """Per-bin (sorted) distances in the kernel's strided bin layout."""
    m, n = dm.shape
    return np.sort(dm.reshape(m, n // TILE, BIN, WIDTH), axis=2)


def test_binmin_matches_numpy(data):
    qs, base = data
    padded, n_valid = pad_base_for_scan(base)
    mins, argmins = bin_top2_blocks(
        jnp.asarray(qs), jnp.asarray(padded), jnp.zeros(1, jnp.int32),
        jnp.full(1, n_valid, jnp.int32), qb=len(qs), cap=padded.shape[0],
        interpret=True,
    )
    mins, argmins = np.asarray(mins), np.asarray(argmins)
    # padded carries zero feature-padding columns: distances are unchanged
    dm = ((qs[:, None] - padded[None, :, : qs.shape[1]]) ** 2).sum(-1)
    dm[:, len(base):] = np.inf
    srt = _numpy_bins(dm)
    L = padded.shape[0] // BIN
    for got, want in [(mins[:, :L], srt[:, :, 0].reshape(len(qs), L)),
                      (mins[:, L:], srt[:, :, 1].reshape(len(qs), L))]:
        np.testing.assert_allclose(
            np.where(np.isfinite(got), got, 0),
            np.where(np.isfinite(want), want, 0), rtol=1e-4, atol=1e-4,
        )
    # argmins point at elements with the reported distances
    got_d = dm[np.arange(len(qs))[:, None], argmins]
    np.testing.assert_allclose(
        np.where(np.isfinite(got_d), got_d, 0),
        np.where(np.isfinite(mins), mins, 0), rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_kernel_matches_reference(data, metric):
    """Kernel (interpret mode) == the plain-JAX reference in the same bin
    layout, ids included: both break ties toward the lower row."""
    qs, base = data
    padded, n_valid = pad_base_for_scan(base)
    got = bin_top2_blocks(
        jnp.asarray(qs), jnp.asarray(padded), jnp.zeros(1, jnp.int32),
        jnp.full(1, n_valid, jnp.int32), metric, qb=len(qs),
        cap=padded.shape[0], interpret=True)
    want = bin_top2_reference(jnp.asarray(qs), jnp.asarray(padded), n_valid,
                              metric)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_fused_topk_high_recall(data, metric):
    qs, base = data
    padded, n_valid = pad_base_for_scan(base)
    d, i = fused_topk(
        jnp.asarray(qs), jnp.asarray(padded), n_valid, 10,
        metric=metric, interpret=True,
    )
    d, i = np.asarray(d), np.asarray(i)
    assert (i < len(base)).all()  # padding never returned
    if metric == "l2":
        dm = ((qs[:, None] - base[None]) ** 2).sum(-1)
    else:
        dm = 1.0 - qs @ base.T
    want_ids = np.argsort(dm, axis=1)[:, :10]
    # bin-collision losses only: recall@10 must be near-perfect
    hits = np.array([
        len(np.intersect1d(i[q], want_ids[q])) for q in range(len(qs))
    ])
    assert hits.mean() / 10 > 0.97, hits.mean() / 10
    # returned distances are exact for the returned ids
    np.testing.assert_allclose(
        d, np.take_along_axis(dm, i, axis=1), rtol=1e-4, atol=1e-4
    )


def test_fused_topk_exhaustive_bins_is_exact(data):
    qs, base = data
    padded, n_valid = pad_base_for_scan(base)
    d, i = fused_topk(
        jnp.asarray(qs), jnp.asarray(padded), n_valid, 1,
        metric="l2", num_candidate_bins=2 * padded.shape[0] // BIN,
        interpret=True,
    )
    dm = ((qs[:, None] - base[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(i)[:, 0], dm.argmin(1))


def test_single_base_is_one_block(data):
    """fused_topk is fused_topk_blocks with one block at row offset 0."""
    qs, base = data
    padded, n_valid = pad_base_for_scan(base)
    d1, i1 = fused_topk(jnp.asarray(qs), jnp.asarray(padded), n_valid, 10,
                        interpret=True)
    d2, i2 = fused_topk_blocks(
        jnp.asarray(qs), jnp.asarray(padded), jnp.zeros(1, jnp.int32),
        jnp.full(1, n_valid, jnp.int32), 10, qb=len(qs),
        cap=padded.shape[0], interpret=True)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_feature_padding_d96():
    """d=96 (not a power of two): the wrapper pads features to LANE; an
    unpadded base and a pre-padded one give identical results."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((TILE, 96)).astype(np.float32)
    qs = rng.standard_normal((40, 96)).astype(np.float32)
    padded, n_valid = pad_base_for_scan(base)
    assert padded.shape == (TILE, 128) and n_valid == TILE
    assert (padded[:, 96:] == 0).all()
    d1, i1 = fused_topk(jnp.asarray(qs), jnp.asarray(base), n_valid, 5,
                        interpret=True)
    d2, i2 = fused_topk(jnp.asarray(qs), jnp.asarray(padded), n_valid, 5,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    assert d1.shape == (40, 5)  # query rows padded to the tile, sliced back
    dm = ((qs[:, None] - base[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(i1)[:, 0], dm.argmin(1))


def test_pad_base_for_scan_shapes():
    x = np.ones((TILE + 1, 130), np.float32)
    padded, n = pad_base_for_scan(x)
    assert n == TILE + 1
    assert padded.shape == (2 * TILE, 2 * LANE)
    assert padded[:n, :130].sum() == x.sum() and padded.sum() == x.sum()


def test_n_valid_masks_rows():
    """Rows >= n_valid never win, even when they are the true nearest."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((TILE, 16)).astype(np.float32)
    qs = base[TILE - 50: TILE - 34].copy()   # queries == masked rows
    n_valid = TILE - 100
    d, i = fused_topk(jnp.asarray(qs), jnp.asarray(base), n_valid, 10,
                      interpret=True)
    i = np.asarray(i)
    assert (i < n_valid).all()
    dm = ((qs[:, None] - base[None, :n_valid]) ** 2).sum(-1)
    np.testing.assert_array_equal(i[:, 0], dm.argmin(1))


def test_multi_block_windows_and_padding_blocks():
    """Blocks at different row offsets scan only their own window's live
    prefix; a size-0 (padding) block returns +inf."""
    rng = np.random.default_rng(5)
    cap, qb = TILE, 32
    flat = rng.standard_normal((3 * cap, 16)).astype(np.float32)
    qs = rng.standard_normal((4 * qb, 16)).astype(np.float32)
    shard = np.asarray([0, 2, 1, 1], np.int32)
    sizes = np.asarray([cap, 5000, 700, 0], np.int32)
    d, i = fused_topk_blocks(
        jnp.asarray(qs), jnp.asarray(flat), jnp.asarray(shard * cap),
        jnp.asarray(sizes), 10, qb=qb, cap=cap, tq=32, interpret=True)
    d, i = np.asarray(d), np.asarray(i)
    assert np.isinf(d[3 * qb:]).all()
    for b in range(3):
        rows = slice(b * qb, (b + 1) * qb)
        win = flat[shard[b] * cap: shard[b] * cap + sizes[b]]
        assert (i[rows] < sizes[b]).all()   # local ids inside the window
        dm = ((qs[rows, None] - win[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(i[rows][:, 0], dm.argmin(1))
        np.testing.assert_allclose(
            d[rows], np.take_along_axis(dm, i[rows], axis=1), rtol=1e-5)


@pytest.mark.parametrize("kwargs,msg", [
    (dict(qb=64, cap=TILE + 1, tq=64), "multiple of TILE"),
    (dict(qb=48, cap=TILE, tq=48), "power of two"),
    (dict(qb=64, cap=TILE, tq=8), "power of two"),
])
def test_bin_top2_blocks_rejects_bad_shapes(kwargs, msg):
    base = jnp.zeros((2 * TILE, 16), jnp.float32)
    qs = jnp.zeros((kwargs["qb"], 16), jnp.float32)
    with pytest.raises(ValueError, match=msg):
        bin_top2_blocks(qs, base, jnp.zeros(1, jnp.int32),
                        jnp.ones(1, jnp.int32), interpret=True, **kwargs)


def test_reference_highest_matches_numpy(data):
    """The plain reference itself against NumPy float64 (it is what the card
    is compared with)."""
    qs, base = data
    padded, n_valid = pad_base_for_scan(base)
    mins, _ = bin_top2_reference(jnp.asarray(qs), jnp.asarray(padded),
                                 n_valid, precision=jax.lax.Precision.HIGHEST)
    q64 = qs.astype(np.float64)
    b64 = padded[:, : qs.shape[1]].astype(np.float64)
    dm = ((q64 ** 2).sum(1)[:, None] + (b64 ** 2).sum(1)[None]
          - 2.0 * q64 @ b64.T)
    dm[:, n_valid:] = np.inf
    want = _numpy_bins(dm)[:, :, 0].reshape(len(qs), -1)
    got = np.asarray(mins)[:, : want.shape[1]]
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
