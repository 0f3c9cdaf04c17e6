"""StreamedShardEngine: beyond-HBM shard-at-a-time serving parity tests."""

import numpy as np
import pytest

from gpann_tpu.cluster.kmeans import balanced_kmeans
from gpann_tpu.cluster.streaming import streaming_capacity_partition
from gpann_tpu.core.partition import partition_to_clusters
from gpann_tpu.eval import compute_ground_truth, kth_neighbor_distance
from gpann_tpu.eval.synth import generate, generate_queries
from gpann_tpu.search.serve import ServingEngine
from gpann_tpu.search.streamed import StreamedShardEngine

N, D, NQ, S, K = 20_000, 24, 64, 8, 10


@pytest.fixture(scope="module")
def setup():
    pts = generate("hard", N, D, seed=7)
    q = generate_queries("hard", NQ, D, seed=7)
    _, assign = balanced_kmeans(pts, k=S, eps=0.05, seed=7)
    clusters = partition_to_clusters(assign, S)
    rng = np.random.default_rng(3)
    rsub = np.sort(rng.choice(N, 2000, replace=False))
    rp, rl = pts[rsub], assign[rsub]
    return pts, q, clusters, rp, rl


@pytest.mark.parametrize("rule", ["min_dist", "frequency", "pyramid", "spann"])
def test_probe_parity_vs_serving_engine(setup, rule):
    pts, q, clusters, rp, rl = setup
    resident = ServingEngine(pts, clusters, rp, rl, scan_mode="exact")
    streamed = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    p1 = resident.probe_order(q, 4, voting_t=30, rule=rule)
    p2 = streamed.probe_order(q, 4, voting_t=30, rule=rule)
    np.testing.assert_array_equal(p1, p2)


def test_search_matches_resident_engine(setup):
    pts, q, clusters, rp, rl = setup
    resident = ServingEngine(pts, clusters, rp, rl, scan_mode="exact")
    streamed = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    d1, i1 = resident.serve(q, K, nprobes=3, voting_t=30)
    d2, i2, stats = streamed.search(q, K, nprobes=3, voting_t=30)
    # same probes -> same candidate pools; the two engines compute f32
    # distances with different (equally exact) formulas, so near-ties at the
    # k boundary may swap — demand near-total id agreement, not bit equality
    overlap = np.mean([
        len(np.intersect1d(i1[r], i2[r])) for r in range(len(q))
    ]) / K
    assert overlap >= 0.99, overlap
    np.testing.assert_allclose(np.sort(d1, axis=1)[:, : K - 1],
                               np.sort(d2, axis=1)[:, : K - 1],
                               rtol=1e-4, atol=1e-4)
    assert stats["shards_scanned"] <= S
    assert stats["bytes_uploaded"] > 0


def test_full_probe_recall_is_exact(setup):
    pts, q, clusters, rp, rl = setup
    streamed = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    gt_i, gt_d = compute_ground_truth(pts, q, K)
    kth = kth_neighbor_distance(gt_d, K)
    curve, _ = streamed.recall_curve(q, K, kth)
    assert curve[-1] >= 0.999  # all shards probed == exact
    assert np.all(np.diff(curve) >= -1e-9)  # monotone in nprobes


def test_memmap_input(tmp_path, setup):
    pts, q, clusters, rp, rl = setup
    path = str(tmp_path / "base.npy")
    np.save(path, pts)
    mm = np.load(path, mmap_mode="r")
    streamed = StreamedShardEngine(mm, clusters, rp, rl, scan_mode="exact")
    d, i, _ = streamed.search(q, K, nprobes=2, voting_t=30)
    assert np.isfinite(d[:, 0]).all()


def test_subcluster_pruning_cuts_bytes_keeps_recall(setup):
    """build_subclusters + search(sub_nprobe=t): fewer uploaded bytes at
    near-equal recall; artifact round-trips through the flat npz form."""
    pts, q, clusters, rp, rl = setup
    eng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    art = eng.build_subclusters(target_sub_size=400, train_sample=2000,
                                seed=3)
    # round-trip the artifact into a fresh engine
    eng2 = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    eng2.load_subclusters(art)
    assert all(
        len(a) == len(b)
        for a, b in zip(eng.sub_members, eng2.sub_members)
    )

    # few queries: per-shard unions stay partial, so pruning shows up in
    # bytes (with many unclustered queries the union covers every sub)
    qs = q[:4]
    gt_i, gt_d = compute_ground_truth(pts, qs, K)
    kth = kth_neighbor_distance(gt_d, K)
    full, sfull = eng.recall_curve(qs, K, kth, max_nprobes=4)
    pruned, spruned = eng2.recall_curve(qs, K, kth, max_nprobes=4,
                                        sub_nprobe=2)
    assert spruned["bytes_uploaded"] < sfull["bytes_uploaded"], (
        spruned["bytes_uploaded"], sfull["bytes_uploaded"])
    # pruning to 2 of ~6 subclusters costs little recall at the last prefix
    assert pruned[-1] >= full[-1] - 0.1, (pruned[-1], full[-1])


def test_subcluster_pruning_u8_base(tmp_path):
    """Sub-cluster build + pruned search on a raw-byte memmap base: rows
    stay u8 end-to-end on host (uploads widen on device), centroids come
    out f32, and the pruned pass still finds real neighbors."""
    n, d, s = 6_000, 16, 4
    path = str(tmp_path / "b.npy")
    pts = generate("hard", n, d, seed=9, dtype="u8", out_path=path)
    assert pts.dtype == np.uint8
    q = generate_queries("hard", 16, d, seed=9, dtype="u8")
    part = streaming_capacity_partition(pts, k=s, eps=0.05, seed=9,
                                        chunk_rows=2048, train_sample=3000)
    clusters = partition_to_clusters(part, s)
    rng = np.random.default_rng(4)
    rsub = np.sort(rng.choice(n, 800, replace=False))
    rp, rl = np.asarray(pts[rsub], np.float32), part[rsub]
    eng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    eng.build_subclusters(target_sub_size=500, train_sample=2000, seed=4)
    assert all(sc.dtype == np.float32 for sc in eng.sub_centroids)
    gt_i, gt_d = compute_ground_truth(np.asarray(pts, np.float32), q, K)
    kth = kth_neighbor_distance(gt_d, K)
    full, sf = eng.recall_curve(q, K, kth)
    pruned, sp = eng.recall_curve(q, K, kth, sub_nprobe=2)
    assert sp["bytes_uploaded"] <= sf["bytes_uploaded"]
    assert full[-1] >= 0.999          # exact at all probes
    assert pruned[-1] >= full[-1] - 0.15


def test_padding_rows_never_displace_neighbors():
    """Advisor regression (round 2, high): zero-padded shard rows score
    |q|^2 under L2; queries near the origin previously got all-inf results
    because padding occupied the top-k before masking."""
    rng = np.random.default_rng(0)
    # points far from the origin, queries AT the origin: padding (dist
    # |q|^2 ~ 0) beats every real point unless masked pre-top-k
    pts = (rng.standard_normal((600, 8)) + 10.0).astype(np.float32)
    clusters = [np.arange(300), np.arange(300, 600)]
    rl = np.repeat([0, 1], 50).astype(np.int32)
    rp = np.concatenate([pts[:50], pts[300:350]])
    eng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    q = np.zeros((4, 8), np.float32)
    d, i, _ = eng.search(q, K, nprobes=2, voting_t=30)
    assert np.isfinite(d).all()
    assert (i >= 0).all()
    # exact: matches brute force
    gt_i, _ = compute_ground_truth(pts, q, K)
    overlap = np.mean([
        len(np.intersect1d(i[r], gt_i[r])) for r in range(len(q))
    ]) / K
    assert overlap >= 0.99, overlap


def test_binned_tiny_shard_no_index_error():
    """Advisor regression (round 2, medium): binned path returned
    padded-row column ids for inf fillers on tiny shards ->
    members[pos] IndexError; now tiny shards take the exact fallback and
    fillers are clamped + id-masked."""
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((400, 16)).astype(np.float32)
    # one tiny shard (30 pts), one larger
    clusters = [np.arange(30), np.arange(30, 400)]
    rl = np.repeat([0, 1], 30).astype(np.int32)
    rp = np.concatenate([pts[:30], pts[30:60]])
    eng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="binned")
    q = rng.standard_normal((8, 16)).astype(np.float32)
    d, i, _ = eng.search(q, K, nprobes=2, voting_t=30)
    # fillers are (-1, inf); every finite-distance id is a real point
    assert ((i >= 0) == np.isfinite(d)).all()


def test_streaming_capacity_partition_train_sample():
    pts = generate("hard", 30_000, 16, seed=11)
    part = streaming_capacity_partition(pts, k=6, eps=0.05, seed=11,
                                        chunk_rows=8192, train_sample=5_000)
    sizes = np.bincount(part, minlength=6)
    assert part.min() >= 0
    assert sizes.max() <= (1.05) * np.ceil(30_000 / 6)


def test_synth_generate_chunked_deterministic(tmp_path):
    a = generate("hard", 5000, 16, seed=5, chunk_rows=1024)
    path = str(tmp_path / "x.npy")
    b = generate("hard", 5000, 16, seed=5, chunk_rows=1024, out_path=path)
    np.testing.assert_array_equal(a, np.asarray(b))
    c = generate("blobs", 1000, 16, seed=5)
    assert c.shape == (1000, 16) and c.dtype == np.float32


def test_synth_quantize_matches_formula():
    """In-place byte quantizer == the functional clip/round formula."""
    from gpann_tpu.eval.synth import U8_SCALE, _quantize_chunk

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((512, 8)) * 4).astype(np.float32)
    u = _quantize_chunk(x.copy(), "u8")
    np.testing.assert_array_equal(
        u, np.clip(np.round(x * U8_SCALE + 128.0), 0, 255).astype(np.uint8))
    i = _quantize_chunk(x.copy(), "i8")
    np.testing.assert_array_equal(
        i, np.clip(np.round(x * U8_SCALE), -128, 127).astype(np.int8))


def test_sliced_scan_matches_unsliced(setup, monkeypatch):
    """Device-memory guard: one ~16.4M-row shard block of a 1B/64-shard
    curve pass plus its f32 widen + feature-pad copies can exceed device
    memory. Shards above GPANN_MAX_SCAN_ROWS scan as
    consecutive row slices merged on host — results must be identical to
    the one-block scan (both exact and binned modes)."""
    pts, q, clusters, rp, rl = setup
    eng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="exact")
    monkeypatch.delenv("GPANN_MAX_SCAN_ROWS", raising=False)
    d1, i1, s1 = eng.search(q, K, nprobes=3, voting_t=30)
    assert eng._scan_row_limit() >= eng.capacity  # one block
    # force every shard (~2.5k rows) through the sliced path
    monkeypatch.setenv("GPANN_MAX_SCAN_ROWS", "1024")
    assert eng._scan_row_limit() < eng.capacity
    d2, i2, s2 = eng.search(q, K, nprobes=3, voting_t=30)
    overlap = np.mean([
        len(np.intersect1d(i1[r], i2[r])) for r in range(len(q))
    ]) / K
    assert overlap >= 0.99, overlap
    np.testing.assert_allclose(np.sort(d1, axis=1)[:, : K - 1],
                               np.sort(d2, axis=1)[:, : K - 1],
                               rtol=1e-4, atol=1e-4)
    # upload accounting reflects the limit-sized blocks
    assert s2["bytes_uploaded"] >= s1["bytes_uploaded"] * 0.5
    assert s2["shards_scanned"] == s1["shards_scanned"]


def test_sliced_scan_binned_mode(monkeypatch):
    """Binned-mode slicing: shards larger than one kernel tile slice at the
    tile-aligned limit and the merged result matches the one-block binned
    scan."""
    from gpann_tpu.search.pallas_scan import TILE

    rng = np.random.default_rng(2)
    n, d, s = 40_000, 16, 2
    pts = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    assign = (np.arange(n) >= n // 2).astype(np.int32)  # 2 x 20k shards
    clusters = partition_to_clusters(assign, s)
    rsub = np.sort(rng.choice(n, 1000, replace=False))
    rp, rl = pts[rsub], assign[rsub]
    q = pts[rng.choice(n, 16, replace=False)] + 0.01
    eng = StreamedShardEngine(pts, clusters, rp, rl, scan_mode="binned",
                              interpret=True)
    monkeypatch.delenv("GPANN_MAX_SCAN_ROWS", raising=False)
    assert eng.capacity > TILE  # 20k-row shards: several tiles
    d1, i1, _ = eng.search(q, K, nprobes=2, voting_t=30)
    monkeypatch.setenv("GPANN_MAX_SCAN_ROWS", str(TILE))
    assert eng._scan_row_limit() == TILE < eng.capacity
    d2, i2, _ = eng.search(q, K, nprobes=2, voting_t=30)
    overlap = np.mean([
        len(np.intersect1d(i1[r], i2[r])) for r in range(len(q))
    ]) / K
    assert overlap >= 0.99, overlap
    np.testing.assert_allclose(np.sort(d1, axis=1)[:, : K - 1],
                               np.sort(d2, axis=1)[:, : K - 1],
                               rtol=1e-4, atol=1e-4)
