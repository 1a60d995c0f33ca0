"""Tracing/profiling hooks (SURVEY.md §5: the reference has none; the
build plan calls for jax.profiler traces with named phase scopes)."""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def phase(name):
    """Named trace scope: shows up in TensorBoard/perfetto profiles and as
    an XLA annotation inside jit."""
    import jax.profiler
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def trace(logdir):
    """Capture a device profile for the enclosed region."""
    import jax.profiler
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Lightweight wall-clock timer for step loops (host side).

    >>> timer = StepTimer()
    >>> for _ in range(n):
    ...     with timer:
    ...         step()
    >>> timer.mean_seconds
    """

    def __init__(self):
        self.times = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean_seconds(self):
        return sum(self.times) / max(len(self.times), 1)

    @property
    def total_seconds(self):
        return sum(self.times)
