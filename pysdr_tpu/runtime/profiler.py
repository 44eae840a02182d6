"""Block-rate profiling against the real-time frame budget.

Equivalent of the reference `Profiler` (duty-cycled cProfile printed against
the nominal frame time, reference profiler.py:27-46) and `Profiler2`
(start/stop wall-clock, profiler.py:49-71). On the device the useful unit is the
block: samples/s, realtime factor, and optional jax.profiler traces.
"""

from __future__ import annotations

import contextlib
import time


class BlockProfiler:
    """Rolling block-time statistics vs the real-time budget."""

    def __init__(self, samples_per_block: int, fs: float, window: int = 50):
        self.spb = samples_per_block
        self.fs = fs
        self.budget_s = samples_per_block / fs  # nominal frame time
        self.window = window
        self._times = []
        self.n_blocks = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def discount(self, dt: float):
        """Exclude dt seconds (e.g. a realtime pacing sleep) from the
        currently-open measurement, so mean_block_s reflects work, not
        idle time."""
        if self._t0 is not None:
            self._t0 += dt

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        self.n_blocks += 1

    @property
    def mean_block_s(self) -> float:
        return sum(self._times) / max(1, len(self._times))

    @property
    def realtime_factor(self) -> float:
        """>1 means faster than real time."""
        m = self.mean_block_s
        return self.budget_s / m if m > 0 else float("inf")

    @property
    def samples_per_s(self) -> float:
        m = self.mean_block_s
        return self.spb / m if m > 0 else float("inf")

    def report(self) -> str:
        return (f"{self.n_blocks} blocks, {self.mean_block_s*1e3:.2f} ms/block "
                f"(budget {self.budget_s*1e3:.2f} ms), "
                f"{self.realtime_factor:.1f}x realtime, "
                f"{self.samples_per_s/1e6:.2f} Msamp/s")


@contextlib.contextmanager
def jax_trace(log_dir: str):
    """jax.profiler trace wrapper (hook point like the commented-out
    cProfile hooks in reference pySDR.py:170-171)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Stopwatch:
    """Profiler2 equivalent: start/stop with accumulated wall time."""

    def __init__(self, tag: str = ""):
        self.tag = tag
        self.total_s = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.count += 1
        return dt
