"""Smoke run of the routed ANN serving path on one NVIDIA GPU.

Drives the system through the entry points a user calls, in one process that
owns the card, and fails unless every phase passes:

1. device   — JAX must see GPUs; prints the card's name and power limit.
2. kernel   — the bin-top-2 scan kernel as compiled for the card against the
              plain references (``topk_neighbors`` at HIGHEST precision and
              NumPy float64) at the serving widths: d=96, one 262,144-row
              shard window, 4096 queries, and a multi-block call shaped like
              the serving engine's block list.
3. build    — ``cli.partition`` (GP) and ``cli.small_scale_queries`` on a
              seeded 500k x 96 .fbin; exact-scan recall at all probes must be
              1.0, the CLI tests' threshold.
4. serve    — the headline configuration (bench.py): 8M x 96 base from seed
              555, the shipped GP partition + router, the binned serving
              engine; recall@10 >= 0.95 against the shipped ground truth,
              with per-batch time and QPS.

``--four-cards`` runs only the distributed path instead: the same 8M
configuration on a 4-card shard mesh against the one-card engine.

Run from the repository root: ``python chip_smoke.py [--four-cards]``. The
last line of standard output is one JSON object with the device.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

K = 10
_T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - _T0:7.1f}s] {msg}", flush=True)


def phase_device(need: int):
    import jax

    from gpann_tpu.core.device import card, require_gpu

    device = require_gpu()
    if device["count"] < need:
        raise RuntimeError(f"need {need} GPUs, JAX sees {device['count']}")
    card_line = card()
    log(f"device: {device['kind']} x{device['count']} | jax {jax.__version__}")
    print(card_line, flush=True)
    return device, card_line


def phase_kernel() -> None:
    import jax
    import jax.numpy as jnp

    from gpann_tpu.core.distances import topk_neighbors
    from gpann_tpu.eval.synth import blobs
    from gpann_tpu.search import pallas_scan as ps

    cap, nq, d = 262_144, 4096, 96
    base, qs = blobs(cap, d, nq, seed=7)
    n = cap - 1000                     # a partial last tile
    pb, _ = ps.pad_base_for_scan(base)
    pbj, qj = jnp.asarray(pb), jnp.asarray(qs)

    # per-bin minima of one window against float64 on a 256-query subsample.
    # rtol 1e-2: the kernel's dot runs in TF32 (inputs round at ~2^-11
    # relative), and |q|^2 + |x|^2 ~ 400 against bin minima of ~50
    mins, _ = ps.bin_top2_blocks(
        jnp.pad(qj, ((0, 0), (0, pb.shape[1] - d))), pbj,
        jnp.zeros(1, jnp.int32), jnp.full(1, n, jnp.int32), qb=nq, cap=cap)
    q64, b64 = qs[:256].astype(np.float64), base.astype(np.float64)
    dm = ((q64 ** 2).sum(1)[:, None] + (b64 ** 2).sum(1)[None]
          - 2.0 * q64 @ b64.T)
    dm[:, n:] = np.inf
    want = dm.reshape(256, cap // ps.TILE, ps.BIN, ps.WIDTH).min(2)
    got = np.asarray(mins[:256, : cap // ps.BIN])
    want = want.reshape(256, -1)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all(), "padding bins not +inf"
    rel = np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin]))
    assert rel < 1e-2, f"bin minima rel err {rel:.2e} vs float64"
    log(f"kernel: per-bin minima max rel err {rel:.2e} vs float64 "
        f"(256 x {want.shape[1]} bins, limit 1e-2)")

    # top-k after the exact f32 rescore vs the exact top-k at HIGHEST.
    # Distances rtol 1e-5: the rescore is plain f32. Recall >= 0.99 with
    # phase2="exact": bin collisions are the only loss the design allows
    kd, ki = ps.fused_topk(qj, pbj, n, K, phase2="exact")
    xd, xi = topk_neighbors(qj, jnp.asarray(base[:n]), K,
                            precision=jax.lax.Precision.HIGHEST)
    ki, xi = np.asarray(ki), np.asarray(xi)
    recall = np.mean([len(np.intersect1d(ki[r], xi[r])) for r in range(nq)])
    recall /= K
    exact = ((qs[:, None, :].astype(np.float64) - base[ki]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(kd), exact, rtol=1e-5, atol=1e-4)
    assert recall >= 0.99, f"fused_topk recall@10 {recall:.4f}"
    log(f"kernel: fused_topk {nq} x {n} recall@10 {recall:.5f} vs exact "
        f"top-k (limit 0.99); rescored distances within rtol 1e-5")

    # the engine's block list: 128-query blocks over 262,144-row windows of a
    # flat 4-shard base, with full, partial and padding (size 0) blocks
    qb, shards = 128, 4
    flat_base, _ = blobs(shards * cap, d, 0, seed=8)
    flat = jnp.asarray(ps.pad_base_for_scan(flat_base)[0])
    shard = np.asarray([0, 0, 1, 1, 2, 3, 3, 3, 3, 3], np.int32)
    sizes = np.asarray([cap, cap, 250_880, 250_880, 131_073, 200_000,
                        200_000, 200_000, 0, 0], np.int32)
    qrows = jnp.asarray(qs[: len(shard) * qb])
    bd, bi = ps.fused_topk_blocks(
        qrows, flat, jnp.asarray(shard * cap), jnp.asarray(sizes), K,
        qb=qb, cap=cap, tq=ps.TQ)
    bd, bi = np.asarray(bd), np.asarray(bi)
    hits = 0
    for b, (s, size) in enumerate(zip(shard, sizes)):
        rows = slice(b * qb, (b + 1) * qb)
        if size == 0:
            assert np.isinf(bd[rows]).all(), f"padding block {b} not +inf"
            continue
        win = flat_base[s * cap: s * cap + size]
        _, wi = topk_neighbors(qrows[rows], jnp.asarray(win), K,
                               precision=jax.lax.Precision.HIGHEST)
        wi = np.asarray(wi)
        hits += sum(len(np.intersect1d(bi[rows][r], wi[r]))
                    for r in range(qb))
        exact = ((qs[rows, None, :].astype(np.float64) - win[bi[rows]]) ** 2
                 ).sum(-1)
        np.testing.assert_allclose(bd[rows], exact, rtol=1e-5, atol=1e-4)
    recall = hits / (K * qb * int((sizes > 0).sum()))
    assert recall >= 0.99, f"multi-block recall@10 {recall:.4f}"
    log(f"kernel: {len(shard)}-block call (qb={qb}, cap={cap}, 2 padding "
        f"blocks) recall@10 {recall:.5f} vs exact per-window top-k")


def phase_build() -> None:
    from gpann_tpu import artifact_dir
    from gpann_tpu.cli.partition import main as partition_main
    from gpann_tpu.cli.small_scale_queries import main as queries_main
    from gpann_tpu.core import write_points
    from gpann_tpu.eval.synth import blobs

    n, shards = 500_000, 16
    base, qs = blobs(n, 96, 1000, seed=11)
    with tempfile.TemporaryDirectory(dir=artifact_dir()) as tmp:
        write_points(os.path.join(tmp, "base.fbin"), base)
        write_points(os.path.join(tmp, "queries.fbin"), qs)
        t0 = time.time()
        assert partition_main([os.path.join(tmp, "base.fbin"),
                               os.path.join(tmp, "part"), str(shards),
                               "GP"]) == 0
        t_part = time.time() - t0
        part = os.path.join(tmp, f"part.k={shards}.GP")
        out = os.path.join(tmp, "out.csv")
        t0 = time.time()
        assert queries_main([os.path.join(tmp, "base.fbin"),
                             os.path.join(tmp, "queries.fbin"),
                             os.path.join(tmp, "gt.bin"), str(K), part, out,
                             "GP"]) == 0
        t_query = time.time() - t0
        rows = [r.split(",") for r in open(out).read().strip().split("\n")]
    final = [r for r in rows[1:]
             if r[2] == "BruteForce" and int(r[3]) == shards]
    assert final and all(float(r[-1]) == 1.0 for r in final), final
    log(f"build: partition {n} x 96 into {shards} GP shards {t_part:.1f}s, "
        f"small_scale_queries {t_query:.1f}s; BruteForce recall@10 at "
        f"{shards} probes = 1.0 for both routers")


def _serve_setup():
    import bench
    import jax.numpy as jnp

    from gpann_tpu.eval import kth_neighbor_distance

    pts, q, art = bench.load_problem()
    kth = kth_neighbor_distance(art["gt_dists"], K)
    return bench, pts, q, art, kth, jnp.asarray(q)


def phase_serve(card_line: str) -> None:
    import jax
    import jax.numpy as jnp

    from gpann_tpu.eval import recall_from_ids
    from gpann_tpu.eval.synth import blob_queries

    bench, pts, q, art, kth, q_dev = _serve_setup()
    t0 = time.time()
    engine = bench.build_engine(pts, art)
    log(f"serve: engine resident in {time.time() - t0:.1f}s "
        f"(capacity {engine.capacity}, dim {engine.dim_pad})")
    nprobes = bench.choose_nprobes(engine, q_dev, kth, art)
    kw = dict(voting_t=bench.VOTING_T, rule=bench.RULE,
              query_block=bench.QUERY_BLOCK)
    t0 = time.time()
    _, ids = engine.serve(q_dev, K, nprobes, **kw)
    log(f"serve: first batch (compile + run) {time.time() - t0:.1f}s")
    recall = recall_from_ids(pts, q, ids, kth, K)
    assert recall >= 0.95, f"serve recall@10 {recall:.4f}"
    log(f"serve: recall@10 {recall:.4f} at nprobes={nprobes} against the "
        f"shipped ground truth (limit 0.95)")
    extra = [jnp.asarray(x) for x in blob_queries(
        4 * bench.NQ, bench.D, bench.SEED, bench.SEED + 2
    ).reshape(4, bench.NQ, bench.D)]
    for b, batch in enumerate(extra):
        t0 = time.perf_counter()
        d, _ = jax.block_until_ready(
            engine.serve_device(batch, K, nprobes, **kw))
        dt = time.perf_counter() - t0
        assert d.shape == (bench.NQ, K) and np.isfinite(np.asarray(d)).all()
        log(f"serve: batch {b} of {bench.NQ}: {dt * 1e3:.2f} ms, "
            f"{bench.NQ / dt:.0f} QPS | {card_line}")


def phase_four_cards() -> None:
    import jax

    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.dist import DistributedServingEngine, shard_mesh
    from gpann_tpu.eval import recall_from_ids

    bench, pts, q, art, kth, q_dev = _serve_setup()
    kw = dict(voting_t=bench.VOTING_T, rule=bench.RULE)
    one = bench.build_engine(pts, art)
    nprobes = bench.choose_nprobes(one, q_dev, kth, art)
    _, i1 = one.serve(q_dev, K, nprobes, query_block=bench.QUERY_BLOCK, **kw)
    del one
    mesh = shard_mesh(jax.devices()[:4], dp=1)
    t0 = time.time()
    dist = DistributedServingEngine(
        pts, partition_to_clusters(art["assign"], bench.SHARDS),
        art["routing_points"], art["routing_labels"], mesh=mesh,
        voting_impl=bench.VOTING_IMPL)
    log(f"four cards: mesh {dict(mesh.shape)}, "
        f"{bench.SHARDS // 4} shards per card, resident in "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    _, i4 = dist.serve(q, K, nprobes, **kw)
    log(f"four cards: first batch (compile + run) {time.time() - t0:.1f}s")
    r1 = recall_from_ids(pts, q, i1, kth, K)
    r4 = recall_from_ids(pts, q, i4, kth, K)
    top1 = float(np.mean(i1[:, 0] == i4[:, 0]))
    log(f"four cards: top-1 agreement {top1:.4f} (limit 0.99); recall@10 "
        f"4 cards {r4:.4f} vs 1 card {r1:.4f} (limit 0.002)")
    assert top1 >= 0.99, top1
    assert abs(r4 - r1) <= 0.002, (r4, r1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    try:
        device, card_line = phase_device(4 if four else 1)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if four:
        phase_four_cards()
    else:
        phase_kernel()
        phase_build()
        phase_serve(card_line)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
