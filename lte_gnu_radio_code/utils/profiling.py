"""Profiling/tracing utilities (SURVEY.md §5: the reference has none —
diagnostics were print() statements; this is the framework's observability
layer).

- simple_timeit: steady-state wall-clock of a jitted callable, with no
  host transfers inside the timed loop.
- trace: context manager around jax.profiler for TensorBoard traces.
- stage_report: per-stage timing table for a pipeline of jitted callables.
"""

from __future__ import annotations

import contextlib
import time

import jax


def simple_timeit(fn, *args, min_seconds: float = 2.0, warmup: int = 3):
    """Returns (seconds_per_call, iters).  No host transfers in the loop."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    iters, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < min_seconds or iters < 3:
        jax.block_until_ready(fn(*args))
        iters += 1
    return (time.perf_counter() - t0) / iters, iters


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace for TensorBoard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage_report(stages: dict, *, min_seconds: float = 1.0) -> dict:
    """{name: (fn, args)} -> {name: seconds_per_call}; prints a table."""
    out = {}
    for name, (fn, args) in stages.items():
        dt, _ = simple_timeit(fn, *args, min_seconds=min_seconds)
        out[name] = dt
        print(f"{name:30s} {dt * 1e3:9.3f} ms")
    return out
