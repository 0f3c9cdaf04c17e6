"""The accelerator a measurement runs on.

Measurement paths call :func:`require_gpu` first: with no GPU they fail
instead of timing the CPU. :func:`card` reads the card's name and power limit,
which stand beside every number a measurement prints (a card set below its
maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices; raises
    ``RuntimeError`` unless they are GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {len(devs)} {devs[0].platform} device(s)")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card() -> str:
    """First card's ``name, power limit`` line as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def power_limit_w(card_line: str) -> float:
    """Watts from a :func:`card` line (``"NVIDIA H100 ..., 700.00 W"``)."""
    return float(card_line.rsplit(",", 1)[1].split()[0])
