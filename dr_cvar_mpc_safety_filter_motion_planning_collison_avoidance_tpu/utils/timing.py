"""Timing and profiling utilities.

Same surface as reference utils/timing.py:8-90 (Timer context manager,
`timeit` decorator, TimingStats aggregator) but JAX-aware: timers use
`time.perf_counter` and can block on async device computation so device
work is actually measured, and per-solve timing info is returned in-memory
in result structs instead of the reference's tmp/*.json file side-channel
(reference core/risk_metrics.py:16-33).
"""

from __future__ import annotations

import contextlib
import functools
import time

import jax
import numpy as np


class Timer:
    """Context-manager timer (reference utils/timing.py:8-40).

    If `sync` is True, `jax.block_until_ready` is applied to the value
    passed to `stop` (or effectively via `block=`) so asynchronous device
    execution is included in the measurement.
    """

    def __init__(self, name: str | None = None, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.start_time = None
        self.elapsed = 0.0

    def start(self):
        self.start_time = time.perf_counter()
        return self

    def stop(self, block=None):
        if self.start_time is None:
            raise ValueError("Timer not started")
        if block is not None:
            jax.block_until_ready(block)
        self.elapsed = time.perf_counter() - self.start_time
        self.start_time = None
        return self.elapsed

    def __enter__(self):
        return self.start()

    def __exit__(self, *args):
        self.stop()
        if self.name and self.verbose:
            print(f"{self.name}: {self.elapsed:.6f} seconds")


def timeit(func):
    """Decorator printing wall-clock time (reference utils/timing.py:42-52)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with Timer(func.__name__):
            return func(*args, **kwargs)

    return wrapper


def time_blocked(fn, *args, **kwargs):
    """Run `fn`, block until device results are ready, return
    (result, elapsed_seconds)."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    jax.block_until_ready(result)
    return result, time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Optional `jax.profiler` trace of the enclosed block.

    The reference has only wall-clock timers (reference
    utils/timing.py:8-90); this is the deep-profiling hook: pass a
    directory to capture an XLA device trace viewable in
    TensorBoard/Perfetto (`xprof`), pass None for a no-op so callers can
    wrap code unconditionally:

        with trace(args.profile_dir):
            run_single_scenario(...)
    """
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a `trace` capture (shows up on the trace
    timeline). Usable as context manager or decorator."""
    return jax.profiler.TraceAnnotation(name)


class TimingStats:
    """Accumulator with mean/std/min/max/count printout
    (reference utils/timing.py:54-90)."""

    def __init__(self):
        self.data: dict[str, list[float]] = {}

    def add(self, name: str, time_value: float):
        self.data.setdefault(name, []).append(time_value)

    def get_stats(self, name: str):
        if not self.data.get(name):
            return None
        times = np.asarray(self.data[name])
        return {
            "mean": float(times.mean()),
            "std": float(times.std()),
            "min": float(times.min()),
            "max": float(times.max()),
            "count": int(times.size),
        }

    def print_stats(self):
        for name in self.data:
            stats = self.get_stats(name)
            print(f"{name}:")
            print(f"  Mean: {stats['mean']:.6f} seconds")
            print(f"  Std:  {stats['std']:.6f} seconds")
            print(f"  Min:  {stats['min']:.6f} seconds")
            print(f"  Max:  {stats['max']:.6f} seconds")
            print(f"  Count: {stats['count']}")
