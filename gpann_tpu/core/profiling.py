"""Tracing / profiling utilities.

Reference parity (SURVEY.md §5.1): the reference hand-rolls timers and
piggybacks distance counters on hnswlib. Accelerator equivalents:

- :func:`trace` — ``jax.profiler`` trace context (view in TensorBoard /
  xprof); wraps a pipeline stage.
- :func:`flops_of_scan` — explicit FLOP accounting: distance computations are
  matmul dimensions, no instrumentation needed (replaces
  ``metric_distance_computations``; README bullet 3 of the reference).
- :class:`StageTimer` — accumulating named stage timers with a report,
  the ``Timer`` + cout narration pattern structured.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace around a pipeline stage."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def flops_of_scan(num_queries: int, num_points: int, dim: int) -> int:
    """FLOPs of one distance scan's matrix product (one TF32 pass at HIGH
    precision on the GPU)."""
    return 2 * num_queries * num_points * dim


def distance_computations(num_queries: int, num_points: int) -> int:
    """The reference's distance-computation counter, analytically."""
    return num_queries * num_points


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {total:.3f}s over {self.counts[name]} calls"
            for name, total in sorted(self.totals.items())
        ]
        return "\n".join(lines)
