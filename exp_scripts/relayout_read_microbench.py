"""Read-path microbenchmark: shard-major store vs chunk-ordered gathers.

VERDICT r3 missing #2: the round-3 streamed engine fancy-indexed each
shard's scattered rows out of a chunk-ordered memmap — measured ~100x over
its upload bound at 250M (2,695 s / 24 GB pass). The reference instead
re-lays points contiguously by cluster before searching
(``src/inverted_index.h:20-41``) and seek-reads contiguous ranges
(``src/distributed_query_benchmark.h:48-84``); ``search/relayout.py`` is
this repo's equivalent. This script isolates the HOST read side of that
choice on identical data — no device, no upload, page-cache warm (the regime
of a resident host serving loop; at 250M the base exceeds what stays warm,
so the contiguous win only grows — scattered reads add disk seeks):

  A. per-shard sorted fancy-index out of the chunk-ordered memmap
     (round-3 streamed.py behavior)
  B. one-time sequential relayout pass (relayout_to_store)
  C. per-shard contiguous reads from the ShardMajorStore

Emits ONE JSON line + exp_outputs/relayout_read_microbench.json.

Usage: [GPANN_SMOKE=1] python exp_scripts/relayout_read_microbench.py
(host-only: it runs JAX on the CPU)
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N, D, SHARDS = 50_000_000, 96, 64   # 4.8 GB u8: 2x the 8M resident regime
if os.environ.get("GPANN_SMOKE"):
    N, D, SHARDS = 200_000, 16, 8
SEED = 555
CHUNK = 1 << 20

_T0 = time.time()


def log(msg):
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    # host-only benchmark: keep JAX off the accelerator
    import jax

    jax.config.update("jax_platforms", "cpu")

    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.search.relayout import ShardMajorStore, relayout_to_store

    tmp = tempfile.mkdtemp(prefix="relayout_bench_")
    base_path = os.path.join(tmp, "base.u8bin")
    base = np.memmap(base_path, dtype=np.uint8, mode="w+", shape=(N, D))
    rng = np.random.default_rng(SEED)
    for s in range(0, N, CHUNK):
        e = min(s + CHUNK, N)
        base[s:e] = rng.integers(0, 256, size=(e - s, D), dtype=np.uint8)
    base.flush()
    log(f"base written: {N}x{D} u8 = {N * D / 1e9:.1f} GB")

    # random assignment: positionally scattered members, the same access
    # pattern a GP/BKM partition produces over a chunk-ordered base
    assign = rng.integers(0, SHARDS, size=N).astype(np.int32)
    clusters = partition_to_clusters(assign, SHARDS)  # sorted member lists
    base_r = np.memmap(base_path, dtype=np.uint8, mode="r", shape=(N, D))

    # A: the round-3 read path (streamed.py r3: rows = points[members])
    t0 = time.time()
    sink = 0
    for b in range(SHARDS):
        rows = np.asarray(base_r[clusters[b]])
        sink += int(rows[0, 0]) + int(rows[-1, -1])
    gather_s = time.time() - t0
    log(f"A gather pass: {gather_s:.1f}s "
        f"({N * D / gather_s / 1e9:.2f} GB/s)")

    # B: one-time sequential relayout pass
    t0 = time.time()
    store_dir = os.path.join(tmp, "store")
    relayout_to_store(base_r, assign, SHARDS, store_dir, chunk_rows=CHUNK)
    relayout_s = time.time() - t0
    log(f"B relayout pass: {relayout_s:.1f}s "
        f"({N * D / relayout_s / 1e9:.2f} GB/s)")

    # C: the round-4 read path (streamed.py r4: store.shard_rows(b)).
    # np.array(copy) materializes the rows into host RAM like pass A does
    # (np.asarray of a memmap is a lazy view) — the streamed engine's
    # consumer copies them into its capacity block either way.
    store = ShardMajorStore(store_dir)
    t0 = time.time()
    for b in range(SHARDS):
        rows = np.array(store.shard_rows(b))
        sink += int(rows[0, 0]) + int(rows[-1, -1])
    contig_s = time.time() - t0
    log(f"C contiguous pass: {contig_s:.1f}s "
        f"({N * D / contig_s / 1e9:.2f} GB/s)")

    # correctness spot-check: shard 0 ids + rows round-trip
    ids0 = np.asarray(store.shard_ids(0)[:1024]).astype(np.int64)
    assert np.array_equal(np.asarray(store.shard_rows(0)[:1024]),
                          np.asarray(base_r[ids0]))

    out = {
        "metric": "relayout_read_speedup",
        "value": round(gather_s / contig_s, 2),
        "unit": "x",
        "n": N, "d": D, "shards": SHARDS, "dtype": "u8",
        "gather_pass_s": round(gather_s, 2),
        "relayout_pass_s": round(relayout_s, 2),
        "contiguous_pass_s": round(contig_s, 2),
        "gather_gbps": round(N * D / gather_s / 1e9, 3),
        "contiguous_gbps": round(N * D / contig_s / 1e9, 3),
        "relayout_amortized_after_passes":
            round(relayout_s / max(gather_s - contig_s, 1e-9), 2),
    }
    os.makedirs("exp_outputs", exist_ok=True)
    with open("exp_outputs/relayout_read_microbench.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)

    import shutil
    shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
