"""Shard-major relayout store + virtual base (search/relayout.py,
eval/synth.py::VirtualPoints) — the 1B-scale layout pieces.

Oracle strategy (SURVEY.md §4): every approximate/streamed path is compared
against its exact in-RAM counterpart on data small enough to hold both.
"""

import numpy as np
import pytest

from gpann_tpu.cluster.streaming import capacity_stream_assign
from gpann_tpu.eval.synth import VirtualPoints, generate, generate_queries
from gpann_tpu.search.relayout import (
    ShardMajorStore,
    capacity_assign_to_store,
    relayout_to_store,
)

N, D, K_SHARDS = 5000, 24, 8
CHUNK = 512


def test_virtual_points_matches_materialized(tmp_path):
    """VirtualPoints regenerates bit-identical rows to generate() with the
    same chunking, for every access pattern."""
    for dtype in ("f32", "u8"):
        mat = generate("hard", N, D, seed=7, chunk_rows=CHUNK, dtype=dtype)
        vp = VirtualPoints("hard", N, D, seed=7, dtype=dtype,
                          chunk_rows=CHUNK)
        assert vp.shape == (N, D) and vp.dtype == mat.dtype
        np.testing.assert_array_equal(vp[100:300], mat[100:300])
        np.testing.assert_array_equal(vp[400:1300], mat[400:1300])  # spans
        np.testing.assert_array_equal(vp[:], mat)
        rng = np.random.default_rng(0)
        idx = rng.choice(N, 777, replace=False)
        np.testing.assert_array_equal(vp[idx], mat[idx])  # fancy, unsorted
        np.testing.assert_array_equal(vp[np.sort(idx)], mat[np.sort(idx)])
        assert vp.iid_rows


def test_relayout_roundtrip(tmp_path, rng):
    """Store rows/ids are exactly the original rows grouped by shard."""
    pts = rng.standard_normal((N, D)).astype(np.float32)
    part = rng.integers(0, K_SHARDS, size=N)
    store = relayout_to_store(pts, part, K_SHARDS, str(tmp_path / "st"),
                              chunk_rows=700)
    assert store.n == N
    seen = np.zeros(N, bool)
    for b in range(K_SHARDS):
        ids = np.asarray(store.shard_ids(b)).astype(np.int64)
        rows = np.asarray(store.shard_rows(b))
        assert len(ids) == store.sizes[b] == (part == b).sum()
        np.testing.assert_array_equal(part[ids], b)
        np.testing.assert_array_equal(rows, pts[ids])
        seen[ids] = True
    assert seen.all()
    # concat view slicing == permuted base
    perm = np.concatenate(
        [np.asarray(store.shard_ids(b)) for b in range(K_SHARDS)]
    ).astype(np.int64)
    cv = store.concat_view()
    np.testing.assert_array_equal(cv[123:2345], pts[perm[123:2345]])
    np.testing.assert_array_equal(cv[np.array([5, 4999, 17])],
                                  pts[perm[[5, 4999, 17]]])
    # orig id mapping (with -1 passthrough)
    pos = np.array([[0, 100, -1], [4999, 1, 2]])
    out = store.orig_ids(pos)
    assert out[0, 2] == -1
    np.testing.assert_array_equal(out[1], perm[[4999, 1, 2]])


def test_fused_assign_matches_capacity_stream_assign(tmp_path, rng):
    """The fused assign+relayout admits every point to the SAME part as
    capacity_stream_assign (identical chunk-order greedy + retry
    semantics), including across checkpointed re-invocations."""
    pts = rng.standard_normal((N, D)).astype(np.float32)
    reps = rng.standard_normal((37, D)).astype(np.float32)
    rep_labels = rng.integers(0, K_SHARDS, size=37)
    # make every part reachable
    rep_labels[:K_SHARDS] = np.arange(K_SHARDS)
    ref_part = capacity_stream_assign(pts, reps, rep_labels, K_SHARDS,
                                      eps=0.05, chunk_rows=CHUNK)

    for tag, max_chunks in (("one_shot", None), ("resumed", 2)):
        out = str(tmp_path / tag)
        calls = 0
        while not capacity_assign_to_store(
            pts, reps, rep_labels, K_SHARDS, out, eps=0.05,
            chunk_rows=CHUNK, max_chunks=max_chunks,
        ):
            calls += 1
            assert calls < 50
        store = ShardMajorStore(out)
        got = np.full(N, -1, np.int64)
        for b in range(K_SHARDS):
            ids = np.asarray(store.shard_ids(b)).astype(np.int64)
            got[ids] = b
            np.testing.assert_array_equal(np.asarray(store.shard_rows(b)),
                                          pts[ids])
        np.testing.assert_array_equal(got, ref_part)
        cap = int(1.05 * np.ceil(N / K_SHARDS))
        assert store.sizes.max() <= cap


def test_store_sample_labels(tmp_path, rng):
    pts = rng.standard_normal((N, D)).astype(np.float32)
    part = rng.integers(0, K_SHARDS, size=N)
    store = relayout_to_store(pts, part, K_SHARDS, str(tmp_path / "st"))
    rows, lbl = store.sample(512, seed=1)
    assert rows.shape == (512, D) and rows.dtype == np.float32
    # every sampled row must exist in its labeled shard
    for b in np.unique(lbl):
        shard_rows = np.asarray(store.shard_rows(int(b)))
        for r in rows[lbl == b][:5]:
            assert (np.abs(shard_rows - r).sum(axis=1) < 1e-6).any()


def test_streamed_engine_store_parity(tmp_path, rng):
    """StreamedShardEngine over a ShardMajorStore returns the same curve
    and candidates as the rows-layout engine on the identical partition."""
    from gpann_tpu.eval import kth_neighbor_distance
    from gpann_tpu.core.distances import topk_neighbors
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.search.streamed import StreamedShardEngine

    pts = generate("hard", N, D, seed=3)
    q = generate_queries("hard", 64, D, seed=3)
    part = rng.integers(0, K_SHARDS, size=N)
    clusters = partition_to_clusters(part, K_SHARDS)
    store = relayout_to_store(pts, part, K_SHARDS, str(tmp_path / "st"))
    rp = pts[::50].copy()
    rl = part[::50].copy()

    kth = np.asarray(
        topk_neighbors(q, pts, 10)[0][:, -1]
    )
    e_rows = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    e_store = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                                  store=store)
    c1, s1 = e_rows.recall_curve(q, 10, kth)
    c2, s2 = e_store.recall_curve(q, 10, kth)
    np.testing.assert_allclose(c1, c2, atol=1e-9)
    assert c2[-1] > 0.99  # all probes -> exact
    d1, i1, _ = e_rows.search(q, 10, K_SHARDS)
    d2, i2, _ = e_store.search(q, 10, K_SHARDS)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
    np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("kind", ["hard", "hard2"])
def test_scale_bench_shard_major_virtual_cli(tmp_path, monkeypatch, kind):
    """End-to-end 1B-choreography rehearsal at toy size: virtual base +
    fused assign/relayout (checkpointed into 3-chunk invocations) + store
    GT + store-sampled router + contiguous curve pass. Parametrized over
    the numpy "hard" generator and the native counter-based "hard2" the
    real 1B run uses (eval/synth.py)."""
    monkeypatch.setenv("GPANN_CACHE_DIR", str(tmp_path / "cache"))
    from gpann_tpu.cli import scale_bench

    args = [
        "--n", "6000", "--d", "16", "--shards", "8", "--nq", "32",
        "--kind", kind,
        "--dtype", "u8", "--method", "gp", "--gp-subsample", "2000",
        "--gp-aggregates", "64", "--train-sample", "2000",
        "--scan-mode", "exact", "--base", "virtual",
        "--layout", "shard-major", "--assign-chunks", "3"]
    out = tmp_path / "scale_sm.csv"
    rc = scale_bench.main(args + ["--out", str(out)])
    assert rc == 0  # first call checkpoints incomplete partition
    calls = 1
    while rc == 0 and not out.exists():
        rc = scale_bench.main(args + ["--out", str(out)])
        calls += 1
        assert calls < 20
    lines = open(out).read().strip().split("\n")
    rows = [l.split(",") for l in lines[1:]]
    assert len(rows) == 8
    assert float(rows[-1][8]) > 0.9   # full-probe recall ~1
    assert float(rows[0][9]) <= 1.05 + 1e-9  # balance cap


def test_subcluster_major_store(tmp_path, rng):
    """Sub-cluster-major relayout: the store stays a valid permutation, the
    sidecar slices partition every shard, pruned search with t >= n_subs
    equals whole-shard search, and real pruning keeps recall sane while
    cutting uploaded bytes."""
    from gpann_tpu.core.distances import topk_neighbors
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.search.streamed import StreamedShardEngine

    pts = generate("hard", N, D, seed=11)
    q = generate_queries("hard", 48, D, seed=11)
    part = rng.integers(0, K_SHARDS, size=N)
    store = relayout_to_store(pts, part, K_SHARDS, str(tmp_path / "st"))
    rp = pts[::50].copy()
    rl = part[::50].copy()

    e = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                            store=store)
    with pytest.raises(ValueError):  # no sidecar yet
        e.search(q, 10, K_SHARDS, sub_nprobe=2)
    e.build_subclusters_store(target_sub_size=100, train_sample=400, seed=1)

    # store still a valid permutation of the base, grouped consistently
    seen = np.zeros(N, bool)
    for b in range(K_SHARDS):
        ids = np.asarray(store.shard_ids(b)).astype(np.int64)
        np.testing.assert_array_equal(np.asarray(store.shard_rows(b)),
                                      pts[ids])
        np.testing.assert_array_equal(part[ids], b)
        seen[ids] = True
        off = e.sub_slices[b]
        assert off[0] == 0 and off[-1] == store.sizes[b]
        assert (np.diff(off) > 0).all()
        assert len(e.sub_centroids[b]) == len(off) - 1
    assert seen.all()

    # a reloaded engine picks the sidecar up automatically
    e2 = StreamedShardEngine(None, None, rp, rl, scan_mode="exact",
                             store=ShardMajorStore(str(tmp_path / "st")))
    assert e2.sub_slices is not None

    kth = np.asarray(topk_neighbors(q, pts, 10)[0][:, -1])
    # t >= max n_subs -> no pruning: exact whole-shard parity
    max_subs = max(len(c) for c in e.sub_centroids)
    d_full, i_full, s_full = e2.search(q, 10, K_SHARDS)
    d_all, i_all, s_all = e2.search(q, 10, K_SHARDS, sub_nprobe=max_subs)
    np.testing.assert_allclose(d_full, d_all, rtol=1e-5)
    np.testing.assert_array_equal(i_full, i_all)

    # real pruning: the small-batch scenario (few queries per shard, so the
    # chosen-sub-cluster union stays well below the shard) uploads fewer
    # bytes; recall stays above a sane floor
    qs = q[:6]
    _, i_f6, s_f6 = e2.search(qs, 10, 2)
    d_p, i_p, s_p = e2.search(qs, 10, 2, sub_nprobe=2)
    assert s_p["bytes_uploaded"] < s_f6["bytes_uploaded"]
    from gpann_tpu.eval import recall_from_ids
    r_full = recall_from_ids(pts, q, i_full, kth, 10)
    r_f6 = recall_from_ids(pts, qs, i_f6, kth[:6], 10)
    r_p = recall_from_ids(pts, qs, i_p, kth[:6], 10)
    assert r_full > 0.99
    # pruning costs recall only relative to the same 2-probe run
    assert r_p > 0.6 * r_f6
