"""Fused serving engine tests: parity with the unfused reference paths."""

import numpy as np
import pytest

from gpann_tpu.cluster import balanced_kmeans
from gpann_tpu.core.partition import partition_to_clusters
from gpann_tpu.eval import compute_ground_truth, kth_neighbor_distance, recall_from_ids
from gpann_tpu.route import FlatRouter, centroid_router
from gpann_tpu.search import IVFIndex
from gpann_tpu.search.serve import ServingEngine


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(555)
    kb, d, n, nq = 8, 16, 4000, 64
    centers = rng.standard_normal((kb, d)).astype(np.float32) * 4
    lbl = rng.integers(0, kb, size=n)
    pts = (centers[lbl] + 0.4 * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, kb, size=nq)]
         + 0.4 * rng.standard_normal((nq, d))).astype(np.float32)
    gt_ids, gt_dists = compute_ground_truth(pts, q, 10)
    _, assign = balanced_kmeans(pts, k=8, eps=0.3, seed=1)
    clusters = partition_to_clusters(assign, 8)
    router = centroid_router(pts, clusters)
    engine = ServingEngine(
        pts, clusters,
        np.asarray(router.points), router.labels_np,
        pad_multiple=128,
    )
    return pts, q, gt_ids, gt_dists, clusters, router, engine


def test_serve_matches_unfused_min_dist(setup):
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    ivf = IVFIndex(pts, clusters)
    probes = router.query(q, num_voting_neighbors=8, rule="min_dist")[:, :3]
    ud, ui = ivf.search_probed_grouped(q, probes, 10)
    fd, fi = engine.serve(q, k=10, nprobes=3, voting_t=8, rule="min_dist",
                          query_block=32)
    np.testing.assert_allclose(fd, ud, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.sort(fi, 1), np.sort(ui, 1))


def test_serve_full_probes_exact(setup):
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    kth = kth_neighbor_distance(gt_dists, 10)
    _, fi = engine.serve(q, k=10, nprobes=8, voting_t=8, query_block=32)
    assert recall_from_ids(pts, q, fi, kth, 10) == 1.0


@pytest.mark.parametrize("rule,floor", [("pyramid", 0.8), ("spann", 0.5),
                                        ("frequency", 0.8)])
def test_serve_rules_run_and_recall(setup, rule, floor):
    # spann deliberately prunes probes within (1+eps)*closest — lower recall
    # at equal nprobes is its design point (hnsw_router.h:76-85)
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    kth = kth_neighbor_distance(gt_dists, 10)
    _, fi = engine.serve(q, k=10, nprobes=4, voting_t=8, rule=rule,
                         query_block=32)
    rec = recall_from_ids(pts, q, fi, kth, 10)
    assert rec > floor, (rule, rec)


@pytest.mark.parametrize("rule", ["min_dist", "pyramid", "spann",
                                  "frequency"])
def test_engine_probe_order_matches_flat_router(setup, rule):
    """The fused engine's probe ranking must equal FlatRouter's for all four
    rules (both implement hnsw_router.h:55-104 with top-T vote folding)."""
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    rng = np.random.default_rng(7)
    # a routing set with several points per shard so voting_t actually cuts
    sample = rng.choice(len(pts), size=256, replace=False)
    assign = np.concatenate(
        [np.full(len(c), b, np.int32) for b, c in enumerate(clusters)]
    )
    order = np.concatenate([np.asarray(c, np.int64) for c in clusters])
    point_shard = np.empty(len(pts), np.int32)
    point_shard[order] = assign
    rpts, rlbl = pts[sample], point_shard[sample]
    flat = FlatRouter(rpts, rlbl, num_shards=8)
    eng = ServingEngine(pts, clusters, rpts, rlbl, pad_multiple=128)
    got = eng.probe_order(q, nprobes=8, voting_t=16, rule=rule)
    want = flat.query(q, num_voting_neighbors=16, rule=rule)
    # FlatRouter pads cut slots with -1; the engine points them at the dummy
    # shard id 8
    want = np.where(want < 0, 8, want)
    np.testing.assert_array_equal(got, want)


def test_recall_curve_matches_looped_serve(setup):
    """The one-compile prefix recall curve must equal the per-nprobes loop of
    serve() + recall_from_ids (what bench.py used to recompile 32x for)."""
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    kth = kth_neighbor_distance(gt_dists, 10)
    curve = engine.recall_curve(q, 10, kth, voting_t=8, query_block=32)
    assert curve.shape == (8,)
    assert np.all(np.diff(curve) >= -1e-6)  # monotone in nprobes
    for p in (1, 3, 8):
        _, fi = engine.serve(q, k=10, nprobes=p, voting_t=8, query_block=32)
        want = recall_from_ids(pts, q, fi, kth, 10)
        np.testing.assert_allclose(curve[p - 1], want, atol=1e-6)


def test_rescore_voting_matches_exact(setup):
    """voting_impl='rescore' (DEFAULT-precision candidate scan + exact f32
    vote rescore)
    must produce near-identical probe lists to the exact HIGH fold."""
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    rp, rl = np.asarray(router.points), router.labels_np
    exact = ServingEngine(pts, clusters, rp, rl, voting_impl="exact")
    resc = ServingEngine(pts, clusters, rp, rl, voting_impl="rescore")
    for rule in ("min_dist", "frequency"):
        pe = exact.probe_order(q, 4, voting_t=8, rule=rule)
        pr = resc.probe_order(q, 4, voting_t=8, rule=rule)
        agree = (pe == pr).mean()
        assert agree > 0.95, (rule, agree)
    kth = kth_neighbor_distance(gt_dists, 10)
    _, fi = resc.serve(q, k=10, nprobes=3, voting_t=8, query_block=32)
    rec = recall_from_ids(pts, q, fi, kth, 10)
    _, fi0 = exact.serve(q, k=10, nprobes=3, voting_t=8, query_block=32)
    rec0 = recall_from_ids(pts, q, fi0, kth, 10)
    assert rec >= rec0 - 0.01, (rec, rec0)


def test_binned_voting_matches_exact(setup):
    """voting_impl='binned' (Pallas bin-top-2 routing matmul + exact f32
    vote rescore) must produce near-identical probe lists to the exact HIGH
    fold on a router large enough to populate many bins."""
    from gpann_tpu.search.pallas_scan import TILE

    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    rng = np.random.default_rng(13)
    # 2048 routing points fill all 64 bins of one tile; bin-top-2 keeps up
    # to 128 finite candidates, comfortably above voting_t=8
    sample = rng.choice(len(pts), size=2048, replace=False)
    assign = np.concatenate(
        [np.full(len(c), b, np.int32) for b, c in enumerate(clusters)]
    )
    order = np.concatenate([np.asarray(c, np.int64) for c in clusters])
    point_shard = np.empty(len(pts), np.int32)
    point_shard[order] = assign
    rpts, rlbl = pts[sample], point_shard[sample]
    exact = ServingEngine(pts, clusters, rpts, rlbl, voting_impl="exact")
    binned = ServingEngine(pts, clusters, rpts, rlbl, voting_impl="binned",
                           interpret=True)
    assert binned.router_n_valid == 2048
    assert binned.router_points.shape[0] == TILE  # padded for the kernel
    for rule in ("min_dist", "frequency"):
        pe = exact.probe_order(q, 4, voting_t=8, rule=rule)
        pb = binned.probe_order(q, 4, voting_t=8, rule=rule)
        agree = (pe == pb).mean()
        assert agree > 0.9, (rule, agree)
    kth = kth_neighbor_distance(gt_dists, 10)
    _, fi = binned.serve(q, k=10, nprobes=3, voting_t=8, query_block=32)
    rec = recall_from_ids(pts, q, fi, kth, 10)
    _, fi0 = exact.serve(q, k=10, nprobes=3, voting_t=8, query_block=32)
    rec0 = recall_from_ids(pts, q, fi0, kth, 10)
    assert rec >= rec0 - 0.02, (rec, rec0)


def test_binned_voting_sparse_bins():
    """Fewer finite bin candidates than voting_t: inf-tail votes must be
    dropped (dummy shard), not counted as frequency votes for shard 0."""
    from gpann_tpu.search.pallas_scan import TILE, WIDTH

    rng = np.random.default_rng(3)
    n = TILE + 2000
    pts = rng.standard_normal((n, 8)).astype(np.float32)
    q = rng.standard_normal((8, 8)).astype(np.float32)
    base = [np.arange(0, n // 2, dtype=np.int32),
            np.arange(n // 2, n, dtype=np.int32)]
    # TILE + 8 routing points: a full tile (WIDTH bins, 2 candidates each)
    # plus 8 rows of a second tile -> 2 * WIDTH + 8 finite candidates, below
    # voting_t: the vote tail is +inf and must not pollute the fold
    rsample = rng.choice(n, size=TILE + 8, replace=False)
    rlbl = (rsample >= n // 2).astype(np.int32)
    voting_t = 2 * WIDTH + 40
    exact = ServingEngine(pts, base, pts[rsample], rlbl,
                          voting_impl="exact")
    binned = ServingEngine(pts, base, pts[rsample], rlbl,
                           voting_impl="binned", interpret=True)
    for rule in ("min_dist", "frequency"):
        pb = binned.probe_order(q, 2, voting_t=voting_t, rule=rule)
        assert set(np.unique(pb)) <= {0, 1, 2}  # valid shards + dummy only
        pe = exact.probe_order(q, 2, voting_t=voting_t, rule=rule)
        # the surviving candidates include each query's nearest routing
        # points; first-probe agreement stays high
        agree = (pe[:, 0] == pb[:, 0]).mean()
        assert agree >= 0.75, (rule, agree)


def test_serve_single_probe(setup):
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    fd, fi = engine.serve(q, k=10, nprobes=1, voting_t=8, query_block=32)
    assert fd.shape == (len(q), 10)
    assert (fi >= 0).all()  # every query got candidates from its first shard


def test_serve_binned_fallback_tiny_shards(setup):
    # shards ~500 points -> too few 128-wide bins for k=10: binned mode must
    # fall back to the exact scan and stay exact
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    kth = kth_neighbor_distance(gt_dists, 10)
    binned = ServingEngine(
        pts, clusters, np.asarray(router.points), router.labels_np,
        pad_multiple=128, scan_mode="binned", interpret=True,
    )
    _, fi = binned.serve(q[:16], k=10, nprobes=8, voting_t=8, query_block=16)
    rec = recall_from_ids(pts, q[:16], fi, kth[:16], 10)
    assert rec == 1.0, rec


def test_serve_binned_mode_large_shards():
    # big enough shards (several kernel tiles) use the pallas path
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((40_000, 16)).astype(np.float32)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    from gpann_tpu.gp.partitioning import random_partition
    from gpann_tpu.core.partition import partition_to_clusters as p2c

    clusters = p2c(random_partition(len(pts), 2), 2)
    router = centroid_router(pts, clusters)
    kth = kth_neighbor_distance(
        compute_ground_truth(pts, q, 10)[1], 10
    )
    binned = ServingEngine(
        pts, clusters, np.asarray(router.points), router.labels_np,
        scan_mode="binned", interpret=True,
    )
    _, fi = binned.serve(q, k=10, nprobes=2, voting_t=2, query_block=16)
    rec = recall_from_ids(pts, q, fi, kth, 10)
    assert rec > 0.97, rec
    # phase2="approx" (lax.approx_max_k candidate-bin pick) must match
    # the exact phase-2 selection within the same recall envelope
    approx = ServingEngine(
        pts, clusters, np.asarray(router.points), router.labels_np,
        scan_mode="binned", interpret=True, scan_phase2="approx",
    )
    _, fa = approx.serve(q, k=10, nprobes=2, voting_t=2, query_block=16)
    rec_a = recall_from_ids(pts, q, fa, kth, 10)
    assert rec_a > 0.97, rec_a
    # scan_nc widens the candidate-bin pool past the max(k,16) default;
    # recall must be monotone-ish (>= the narrow pool's envelope) and the
    # knob must plumb through to the kernel without shape errors
    wide = ServingEngine(
        pts, clusters, np.asarray(router.points), router.labels_np,
        scan_mode="binned", interpret=True, scan_phase2="approx",
        scan_nc=32,
    )
    _, fw = wide.serve(q, k=10, nprobes=2, voting_t=2, query_block=16)
    rec_w = recall_from_ids(pts, q, fw, kth, 10)
    assert rec_w >= rec_a - 1e-9, (rec_w, rec_a)


def test_serve_overlapping_dedup():
    rng = np.random.default_rng(21)
    pts = rng.standard_normal((1000, 8)).astype(np.float32)
    q = rng.standard_normal((16, 8)).astype(np.float32)
    base = [np.arange(0, 600, dtype=np.int32), np.arange(400, 1000, dtype=np.int32)]
    router = centroid_router(pts, base)
    engine = ServingEngine(pts, base, np.asarray(router.points),
                           router.labels_np, pad_multiple=128)
    assert engine.overlapping
    d, i = engine.serve(q, k=10, nprobes=2, voting_t=2, query_block=16)
    for row in i:
        row = row[row >= 0]
        assert len(np.unique(row)) == len(row)  # no duplicate ids returned


def test_serve_scan_matches_serve(setup):
    """serve_scan (one lax.scan program over a batch window) must agree
    batch-for-batch with per-dispatch serve — same pipeline, different
    submission granularity."""
    pts, q, gt_ids, gt_dists, clusters, router, engine = setup
    batches = np.stack([q, np.roll(q, 7, axis=0)])
    sd, si = engine.serve_scan(batches, k=10, nprobes=3, voting_t=8,
                               query_block=32)
    sd, si = np.asarray(sd), np.asarray(si)
    for r in range(2):
        fd, fi = engine.serve(batches[r], k=10, nprobes=3, voting_t=8,
                              query_block=32)
        np.testing.assert_allclose(sd[r], fd, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(si[r], fi)
