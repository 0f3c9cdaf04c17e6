"""End-to-end CLI integration tests on tiny synthetic data (CPU)."""

import os

import numpy as np
import pytest

from gpann_tpu.core import read_clusters, write_points


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(555)
    centers = rng.standard_normal((6, 12)).astype(np.float32) * 4
    lbl = rng.integers(0, 6, size=1500)
    pts = (centers[lbl] + 0.4 * rng.standard_normal((1500, 12))).astype(np.float32)
    q = (centers[rng.integers(0, 6, size=20)]
         + 0.4 * rng.standard_normal((20, 12))).astype(np.float32)
    write_points(str(tmp / "base.fbin"), pts)
    write_points(str(tmp / "queries.fbin"), q)
    return tmp


def test_partition_cli(data):
    from gpann_tpu.cli.partition import main

    rc = main([str(data / "base.fbin"), str(data / "part"), "4", "BalancedKMeans"])
    assert rc == 0
    clusters = read_clusters(str(data / "part.k=4.BalancedKMeans"))
    assert len(clusters) == 4
    assert sum(len(c) for c in clusters) == 1500


def test_small_scale_queries_cli(data):
    from gpann_tpu.cli.small_scale_queries import main

    part = str(data / "part.k=4.BalancedKMeans")
    if not os.path.exists(part):
        test_partition_cli(data)
    rc = main([
        str(data / "base.fbin"), str(data / "queries.fbin"),
        str(data / "gt.bin"), "10", part, str(data / "out.csv"),
        "BalancedKMeans",
    ])
    assert rc == 0
    lines = open(data / "out.csv").read().strip().split("\n")
    assert lines[0].startswith("partitioning,routing")
    # max-probes rows must reach recall 1.0
    final = [l for l in lines[1:] if l.split(",")[3] == "4"]
    assert all(float(l.split(",")[-1]) == 1.0 for l in final), final


def test_query_attribution_and_convert_cli(data):
    from gpann_tpu.cli.convert import main as convert_main
    from gpann_tpu.cli.query_attribution import main as qa_main

    part = str(data / "part.k=4.BalancedKMeans")
    if not os.path.exists(part):
        test_partition_cli(data)
    rc = qa_main([
        str(data / "base.fbin"), str(data / "queries.fbin"),
        str(data / "gt.bin"), "10", part, "4", str(data / "qa"),
        "BalancedKMeans",
    ])
    assert rc == 0
    assert os.path.exists(data / "qa.routes")
    assert os.path.exists(data / "qa.searches")
    pareto = open(data / "qa.pareto").read().strip().split("\n")
    assert len(pareto) >= 2
    best_recall = max(float(l.split(",")[8]) for l in pareto[1:])
    assert best_recall == 1.0

    rc = convert_main([
        str(data / "qa.routes"), str(data / "qa.searches"), "4", "4", "10",
        str(data / "qa2"), "BalancedKMeans",
    ])
    assert rc == 0
    # re-analysis reproduces the same recall column values
    a = sorted(open(data / "qa.csv").read().strip().split("\n")[1:])
    b = sorted(open(data / "qa2.csv").read().strip().split("\n")[1:])
    assert [r.split(",")[8] for r in a] == [r.split(",")[8] for r in b]


def test_oracle_recall_cli(data):
    from gpann_tpu.cli.oracle_recall import main

    part = str(data / "part.k=4.BalancedKMeans")
    if not (os.path.exists(part) and os.path.exists(data / "qa.routes")):
        test_query_attribution_and_convert_cli(data)
    rc = main([
        str(data / "gt.bin"), str(data / "qa.routes"), "10", part,
        "BalancedKMeans", str(data / "oracle.csv"),
    ])
    assert rc == 0
    lines = open(data / "oracle.csv").read().strip().split("\n")
    oracle_rows = [l for l in lines[1:] if l.endswith(",oracle")]
    assert len(oracle_rows) == 4
    # oracle curve reaches 1.0 at full probes
    assert float(oracle_rows[-1].split(",")[2]) == 1.0


def test_analyze_approximation_losses_cli(data):
    from gpann_tpu.cli.analyze_approximation_losses import main

    part = str(data / "part.k=4.BalancedKMeans")
    if not os.path.exists(part):
        test_partition_cli(data)
    rc = main([
        str(data / "base.fbin"), str(data / "queries.fbin"),
        str(data / "gt.bin"), "10", part, "BalancedKMeans",
        str(data / "losses.csv"),
    ])
    assert rc == 0
    lines = open(data / "losses.csv").read().strip().split("\n")
    types = {l.split(",")[-1] for l in lines[1:]}
    assert types == {"brute-force-routing", "kmeans-tree-sample",
                     "uniform-sample", "single-center"}


def test_distributed_bench_cli(data):
    from gpann_tpu.cli.distributed_bench import main

    part = str(data / "part.k=4.BalancedKMeans")
    if not os.path.exists(part):
        test_partition_cli(data)
    rc = main([
        str(data / "base.fbin"), str(data / "queries.fbin"), "10", part, "2",
    ])
    assert rc == 0


def test_scale_bench_isolate_stages_cli(tmp_path, monkeypatch, capsys):
    """scale_bench end-to-end as a user runs it at scale, every build stage
    (GP aggregates + partition, ground truth, router, sub-clusters) and the
    curve pass in one process, with a byte base and in-shard pruning."""
    monkeypatch.setenv("GPANN_CACHE_DIR", str(tmp_path / "cache"))
    from gpann_tpu.cli import scale_bench

    out = tmp_path / "scale.csv"
    rc = scale_bench.main([
        "--n", "6000", "--d", "16", "--shards", "8", "--nq", "32",
        "--dtype", "u8", "--method", "gp", "--gp-subsample", "2000",
        "--gp-aggregates", "64", "--train-sample", "2000",
        "--scan-mode", "exact", "--sub-nprobe", "2", "--sub-size", "256",
        "--out", str(out)])
    assert rc == 0
    err = capsys.readouterr().err
    # every stage ran
    for stage in ("partition: sizes", "ground truth ready", "router ready",
                  "sub-clusters ready", "curve pass"):
        assert stage in err, err[-2000:]
    lines = open(out).read().strip().split("\n")
    assert lines[0].startswith("n,d,shards")
    rows = [l.split(",") for l in lines[1:]]
    assert len(rows) == 8
    # recall at full probes ~1.0 (pruning keeps it a top-k subset, allow slack)
    assert float(rows[-1][8]) > 0.9
    # balance cap respected
    assert float(rows[0][9]) <= 1.05 + 1e-9


def test_scale_bench_mips_cli(tmp_path, monkeypatch):
    """Runtime-metric parity on the scale path: the reference needs a second
    compile tree for MIPS (CMakeLists.txt:54-59, T2I-1B); here it is a flag.
    Exact scan, GP partitioner."""
    monkeypatch.setenv("GPANN_CACHE_DIR", str(tmp_path / "cache"))
    from gpann_tpu.cli import scale_bench

    out = tmp_path / "scale_mips.csv"
    rc = scale_bench.main([
        "--n", "6000", "--d", "16", "--shards", "8", "--nq", "32",
        "--metric", "mips", "--method", "gp", "--gp-subsample", "2000",
        "--gp-aggregates", "64", "--train-sample", "2000",
        "--scan-mode", "exact", "--out", str(out)])
    assert rc == 0
    rows = [l.split(",") for l in open(out).read().strip().split("\n")[1:]]
    assert len(rows) == 8
    assert float(rows[-1][8]) > 0.95       # full probes ~exact under MIPS
    assert float(rows[0][9]) <= 1.05 + 1e-9


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/jax_cache"])
def test_compile_cache_dir_rule(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and the
    package sets nothing; otherwise the cache is a fixed path inside the
    checkout (git-ignored)."""
    import gpann_tpu

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(gpann_tpu.CHECKOUT, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        want = None
    assert gpann_tpu._compilation_cache_dir() == want
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.samefile(gpann_tpu.CHECKOUT, repo)
    assert ".jax_cache/" in open(os.path.join(repo, ".gitignore")).read()


def test_artifact_dir_rule(tmp_path, monkeypatch):
    """Cached artifacts go to GPANN_CACHE_DIR when set, else a git-ignored
    directory inside the checkout; nothing under HOME."""
    import gpann_tpu

    monkeypatch.setenv("GPANN_CACHE_DIR", str(tmp_path / "a"))
    assert gpann_tpu.artifact_dir() == str(tmp_path / "a")
    assert (tmp_path / "a").is_dir()
    monkeypatch.delenv("GPANN_CACHE_DIR")
    default = gpann_tpu.artifact_dir()
    assert default == os.path.join(gpann_tpu.CHECKOUT, ".bench_cache")
