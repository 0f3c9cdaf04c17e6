"""Does the shard mesh axis actually DIVIDE work? (VERDICT r4 task 7)

The 2-/4-process parity tests prove the fused distributed serve is correct;
this measures that it scales: the same total workload (200k x 64 base, 16
shards, 2048 queries, nprobes=4, k=10) served by
:class:`~gpann_tpu.dist.mesh.DistributedServingEngine` on a virtual CPU mesh
of 1, 2, 4, 8 devices — one subprocess per device count
(``xla_force_host_platform_device_count`` is process-global).

Reading the numbers: this host has ONE physical core, so n virtual devices
timeshare it and wall time cannot *drop* with n. The scaling signal is that
wall time stays ~FLAT at fixed total work: each device routes its dp-slice
and scans only its ``S / n`` shards' blocks (``mesh.py::_build_serve``,
``in_specs=P("shard", ...)``), so the sum of per-device work is constant.
If every device scanned every shard, time would grow ~linearly with n.
On real hardware the same program maps devices 1:1 to cards and the flat
curve becomes ~n-fold throughput (the reference's multi-rank scaling,
``distributed_bench.cpp:46-58`` timing protocol).

Usage: python exp_scripts/mesh_scaling_cpu.py
Emits exp_outputs/mesh_scaling_cpu.csv + one JSON line.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, D, SHARDS, NQ, NPROBES, K = 200_000, 64, 16, 2048, 4, 10
SEED = 555
REPS = 3


def child(ndev: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gpann_tpu.core.partition import partition_to_clusters
    from gpann_tpu.dist.mesh import DistributedServingEngine, shard_mesh

    assert jax.device_count() == ndev, (jax.device_count(), ndev)
    rng = np.random.default_rng(SEED)
    centers = rng.standard_normal((SHARDS, D)).astype(np.float32) * 3.0
    lbl = rng.integers(0, SHARDS, size=N)
    pts = (centers[lbl] + rng.standard_normal((N, D))).astype(np.float32)
    q = (centers[rng.integers(0, SHARDS, size=NQ)]
         + rng.standard_normal((NQ, D))).astype(np.float32)
    # balanced-enough partition for a fixed workload: the true labels
    clusters = partition_to_clusters(lbl, SHARDS)
    rp = pts[::100].copy()
    rl = lbl[::100].copy()
    eng = DistributedServingEngine(pts, clusters, rp, rl,
                                   mesh=shard_mesh(dp=1))
    d, i = eng.serve(q, K, NPROBES)  # compile + warm
    t0 = time.time()
    for _ in range(REPS):
        d, i = eng.serve(q, K, NPROBES)
    dt = (time.time() - t0) / REPS
    print(json.dumps({"ndev": ndev, "ms_per_batch": round(dt * 1e3, 1),
                      "qps": round(NQ / dt, 1),
                      "top1_q0": int(i[0, 0])}), flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]))
        return 0
    rows = []
    for ndev in (1, 2, 4, 8):
        env = dict(os.environ,
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}")
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(ndev)],
            env=env, capture_output=True, text=True, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(f"# ndev={ndev}: {row['ms_per_batch']} ms/batch", flush=True)
    # the answer must not depend on the mesh size
    assert len({r["top1_q0"] for r in rows}) == 1, rows
    os.makedirs("exp_outputs", exist_ok=True)
    with open("exp_outputs/mesh_scaling_cpu.csv", "w") as f:
        f.write("ndev,ms_per_batch,qps\n")
        for r in rows:
            f.write(f"{r['ndev']},{r['ms_per_batch']},{r['qps']}\n")
    flat = rows[-1]["ms_per_batch"] / rows[0]["ms_per_batch"]
    print(json.dumps({"metric": "mesh_scaling_time_ratio_8dev_vs_1dev",
                      "value": round(flat, 3), "unit": "x (flat=1, undivided~8)",
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
