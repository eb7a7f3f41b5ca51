"""Device profiling: jax.profiler traces + a simple stage report.

The reference's observability is compile-time-gated wall-clock timers
(SURVEY.md §5; reference include/timer.hpp). The replacement here:

  * `trace(logdir)` — capture a full XLA device trace viewable in
    TensorBoard or Perfetto (covers what the reference's LOG>=3 "(Inc)"
    spans did, per-op instead of per-stage).
  * `device_seconds(fn)` — best-of steady-state timing of a jitted
    callable, ending in block_until_ready.
  * `annotate(name)` — a named host span in the profiler timeline.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace into logdir."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_seconds(fn: Callable, *args, iters: int = 3) -> float:
    """Best-of-iters steady-state seconds for fn(*args) (compiles first)."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)
