"""Accumulating timer (reference ``Timer``, ``src/defs.h:61-98``) plus a
device-aware measurement helper following the reference's benchmark hygiene:
median of repetitions (``shard_searches.cpp:57-68``) and explicit completion
barriers (device equivalent of wall-clock timing: ``block_until_ready``)."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import jax


class Timer:
    def __init__(self) -> None:
        self.total_duration = 0.0
        self._start: float | None = None

    def start(self) -> None:
        if self._start is not None:
            raise RuntimeError("timer already running")
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("timer not running")
        elapsed = time.perf_counter() - self._start
        self.total_duration += elapsed
        self._start = None
        return elapsed

    def restart(self) -> float:
        elapsed = self.stop()
        self.start()
        return elapsed

    @property
    def elapsed(self) -> float:
        return self.total_duration


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 1):
    """Median-of-reps timing with device sync; returns (median_s, result)."""
    result = None
    for _ in range(max(warmup, 0)):
        result = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), result
