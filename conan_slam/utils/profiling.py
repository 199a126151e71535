"""Profiling and step-timing hooks.

The reference has no instrumentation (SURVEY.md section 5); these utilities
provide the update-steps/s counters the benchmarks report and optional XLA
trace capture for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timer fenced on the device.

    JAX dispatches asynchronously, so the block appends its outputs to the
    yielded list and the timer waits on them with ``block_until_ready``
    before it reads the clock.
    """

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        fence = []
        yield fence
        jax.block_until_ready(fence)
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    def steps_per_s(self, steps: int) -> float:
        return steps / self.best
