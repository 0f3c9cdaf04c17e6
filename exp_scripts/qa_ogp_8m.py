"""8M QueryAttribution artifact with an OVERLAPPING clustering (OGP).

VERDICT r3 weak #8: the committed QA artifact stops at 1M with a disjoint
partition; the vectorized overlap combine path (eval/combination.py
attribute_recall_curves first-probe dedup) is covered only by unit tests.
This driver runs the full C18 pipeline (run_query_attribution.cpp) at the
8M resident scale on OGP clusters: hard-mixture base/queries written as
.fbin, centroid-ranked overlap (o=0.2) on the hard-serve GP partition,
then cli.query_attribution end-to-end -> *.routes, *.searches, 19-col CSV
+ Pareto.

Requires exp_scripts/hard_serve_bench.py's cache (GP partition + GT).
Usage: python exp_scripts/qa_ogp_8m.py [budgets_csv]   (default 40k,400k)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N, D, NQ, SHARDS, K = 8_000_000, 96, 1024, 32, 10
if os.environ.get("GPANN_SMOKE"):
    N, D, NQ, SHARDS = 40_000, 16, 128, 4
SEED = 555
OVERLAP = 0.2

_T0 = time.time()


def log(msg):
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    from gpann_tpu.core.metis_io import write_clusters
    from gpann_tpu.core.pointset import write_points
    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.eval.synth import dataset_cached, generate_queries
    from gpann_tpu.gp.overlap import (apply_extra_assignments,
                                      centroid_overlap_streamed)
    from gpann_tpu.gp.scale import gp_aggregates

    budgets = sys.argv[1] if len(sys.argv) > 1 else "40000,400000"
    from gpann_tpu import artifact_dir

    cache_dir = artifact_dir()
    # the full-scale NQ here (1024) is a prefix of hard_serve_bench's 4096
    # query draw ONLY if the generator seeds identically; write our own GT
    # file path and let the CLI verify/compute as needed.
    hs_cache = os.path.join(cache_dir, f"hardserve_{SEED}_{N}_{D}_4096_{SHARDS}.npz")
    if os.environ.get("GPANN_SMOKE"):
        hs_cache = os.path.join(cache_dir, f"hardserve_{SEED}_{N}_{D}_128_{SHARDS}.npz")
    from _hardserve_cache import ensure_hardserve

    if not ensure_hardserve(hs_cache):
        print("run exp_scripts/hard_serve_bench.py first", file=sys.stderr)
        return 1
    art = dict(np.load(hs_cache))
    pts, _ = dataset_cached("hard", N, D, SEED)
    q_full = generate_queries("hard", max(NQ, 4096) if not os.environ.get("GPANN_SMOKE") else NQ, D, SEED)
    q = q_full[:NQ]

    workdir = os.path.join(cache_dir, "qa_ogp_8m")
    os.makedirs(workdir, exist_ok=True)
    base_f = os.path.join(workdir, "base.fbin")
    query_f = os.path.join(workdir, "queries.fbin")
    gt_f = os.path.join(workdir, "gt.bin")
    clusters_f = os.path.join(workdir, "ogp.clusters")

    if not os.path.exists(base_f):
        write_points(base_f, np.asarray(pts, np.float32))
        log("base.fbin written")
    if not os.path.exists(query_f):
        write_points(query_f, np.asarray(q, np.float32))

    if not os.path.exists(clusters_f):
        t0 = time.time()
        assign = np.asarray(art["assign"])
        clusters = partition_to_clusters(assign, SHARDS)
        # cluster representatives a la the reference's centroid method
        # (64/cluster k-means), trained on a subsample for scale
        rng = np.random.default_rng(SEED + 3)
        sub = np.sort(rng.choice(N, size=min(2_000_000, N // 2),
                                 replace=False))
        reps, rep_lbl = gp_aggregates(
            np.asarray(pts[sub], np.float32), assign[sub], SHARDS,
            64 * SHARDS, seed=SEED)
        cap2 = int((1.0 + 0.05) * (1.0 + OVERLAP) * N / SHARDS)
        ep, ec = centroid_overlap_streamed(
            pts, assign, reps, rep_lbl, SHARDS, cap2, int(OVERLAP * N))
        cover = apply_extra_assignments(clusters, ep, ec)
        write_clusters(clusters_f, cover)
        log(f"OGP cover written ({time.time()-t0:.0f}s, "
            f"{sum(len(c) for c in cover)} assignments)")

    from gpann_tpu.cli.query_attribution import main as qa_main

    suffix = "_smoke" if os.environ.get("GPANN_SMOKE") else ""
    out_prefix = os.path.join("exp_outputs", f"qa_ogp_8M_hard{suffix}")
    os.makedirs("exp_outputs", exist_ok=True)
    rc = qa_main([base_f, query_f, gt_f, str(K), clusters_f, str(SHARDS),
                  out_prefix, "OGP", "l2", budgets])
    log(f"qa done rc={rc}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
