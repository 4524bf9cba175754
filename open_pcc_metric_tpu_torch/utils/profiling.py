"""Timers, throughput counters and a torch.profiler trace hook.

The counterpart of the JAX package's ``utils/profiling.py``: ``Timer``
accumulates named stage times, ``mpoints_per_sec`` turns a point count and
a wall time into Mpoints/s, and ``trace`` wraps ``torch.profiler`` around a
block of work and writes a Chrome trace file into a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
import typing


class Timer:
    """Accumulating named stage timer.

    >>> t = Timer()
    >>> with t.stage("nn"):
    ...     work()
    >>> t.times["nn"]
    """

    def __init__(self) -> None:
        self.times: typing.Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def total(self) -> float:
        return sum(self.times.values())


def mpoints_per_sec(n_points: int, seconds: float) -> float:
    if seconds <= 0:
        return float("inf")
    return n_points / seconds / 1e6


@contextlib.contextmanager
def trace(log_dir: typing.Optional[str]):
    """torch.profiler trace of the block (CPU activity, and CUDA when a
    card is present), written on exit as ``trace-<time>-<pid>.json`` into
    ``log_dir`` (created if missing); a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))
