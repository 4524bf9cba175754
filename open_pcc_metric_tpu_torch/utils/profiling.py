"""Timers, throughput counters, the port's spans and a torch.profiler
trace hook.

The counterpart of the JAX package's ``utils/profiling.py``: ``Timer``
accumulates named stage times, ``mpoints_per_sec`` turns a point count and
a wall time into Mpoints/s, and ``trace`` wraps ``torch.profiler`` around a
block of work and writes a Chrome trace file into a directory.

Spans name the host's work inside the port (``pcc.load``, ``pcc.sweep``,
``pcc.obb_wait``, ...). Tracing is on exactly while a torch profiler runs
on the calling thread, or where ``bind`` handed it down from such a
thread; there is no other switch. Off, ``span`` returns one shared no-op
after a profiler check and a context-variable lookup: no allocation, no
CUDA event, no synchronisation. On, a span opens a ``cpu_op`` range of the
profiler (``_RecordFunctionFast``) on a thread the profiler traces, so the
trace labels the card's idle gaps by it, and appends a ``Record`` to an
in-memory recorder on every thread, on the profiler's clock (Unix-epoch
nanoseconds); ``totals`` sums the recorder by name and ``reset`` empties
it.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import json
import os
import threading
import time
import typing

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # spans go to the recorder only
    _RecordFunctionFast = None

_profiler_enabled = torch.autograd._profiler_enabled


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


class Record:
    """One finished span: its name, the native id of the thread it ran on,
    its start and end (Unix-epoch ns, the profiler's clock), the span open
    around it (on this thread, or on the thread that ``bind`` handed it
    from) and the pair it belongs to."""

    __slots__ = ("name", "thread", "start_ns", "end_ns", "parent", "pair")

    def __init__(self, name: str, parent: typing.Optional["Record"] = None,
                 pair: typing.Optional[int] = None, thread: int = 0,
                 start_ns: int = 0, end_ns: int = 0) -> None:
        self.name, self.parent, self.pair = name, parent, pair
        self.thread, self.start_ns, self.end_ns = thread, start_ns, end_ns

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, thread={self.thread}, "
                f"pair={self.pair}, {self.end_ns - self.start_ns} ns)")


class Total(typing.NamedTuple):
    calls: int
    seconds: float
    self_seconds: float  # less what its children on its thread cover


# (open span or None, pair id or None) while tracing is on in this
# context; None where it is off or no span is open yet.
_STATE: contextvars.ContextVar = contextvars.ContextVar("pcc_span",
                                                        default=None)
_RECORDS: typing.List[Record] = []
_PAIRS = itertools.count()


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("record", "fast", "token")

    def __init__(self, name: str, state, pair, traced: bool) -> None:
        parent, inherited = state or (None, None)
        self.record = Record(name, parent,
                             inherited if pair is None else pair)
        self.fast = (_RecordFunctionFast(name)
                     if traced and _RecordFunctionFast is not None else None)

    # Each clock read sits next to the profiler's range, so the record
    # matches its profiler event to within a few bytecodes.
    def __enter__(self) -> Record:
        r = self.record
        r.thread = threading.get_native_id()
        self.token = _STATE.set((r, r.pair))
        if self.fast is not None:
            self.fast.__enter__()
        r.start_ns = time.time_ns()
        return r

    def __exit__(self, *exc) -> bool:
        r = self.record
        r.end_ns = time.time_ns()
        if self.fast is not None:
            self.fast.__exit__(*exc)
        _STATE.reset(self.token)
        _RECORDS.append(r)
        return False


def span(name: str, pair: typing.Optional[int] = None):
    """A context manager that records ``name`` around its block while
    tracing is on, and does nothing otherwise. ``pair`` gives the span and
    every span inside it that pair id (``new_pair``); by default a span
    carries the id of the span around it."""
    state = _STATE.get()
    traced = _profiler_enabled()
    if state is None and not traced:
        return _OFF
    return _Span(name, state, pair, traced)


def spanned(name: str):
    """Decorator: the whole call runs inside ``span(name)``. Off, the call
    goes straight through (``span``'s check without the no-op's ``with``,
    which costs more than the check)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            state = _STATE.get()
            traced = _profiler_enabled()
            if state is None and not traced:
                return fn(*args, **kwargs)
            with _Span(name, state, None, traced):
                return fn(*args, **kwargs)

        return inner

    return wrap


def new_pair() -> int:
    """A fresh pair id for ``span`` and ``bind``."""
    return next(_PAIRS)


def bind(fn: typing.Callable, pair: typing.Optional[int] = None
         ) -> typing.Callable:
    """``fn``, to be run on another thread with this thread's trace
    context: tracing on or off, the open span as the parent of its spans,
    and the pair id (``pair`` where given). ``fn`` itself where tracing is
    off."""
    state = _STATE.get()
    if state is None:
        if not _profiler_enabled():
            return fn
        state = (None, None)
    if pair is not None:
        state = (state[0], pair)

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        token = _STATE.set(state)
        try:
            return fn(*args, **kwargs)
        finally:
            _STATE.reset(token)

    return bound


def records() -> typing.List[Record]:
    """A copy of the recorder, in the order the spans ended."""
    return list(_RECORDS)


def reset() -> None:
    """Empty the recorder."""
    _RECORDS.clear()


def _within(r: Record, name: str) -> bool:
    p = r.parent
    while p is not None:
        if p.name == name:
            return True
        p = p.parent
    return False


def totals(*, thread: typing.Optional[int] = None,
           within: typing.Optional[str] = None) -> typing.Dict[str, Total]:
    """The recorder summed by span name: calls, seconds and self seconds.
    ``thread`` keeps the spans of one thread (its native id), ``within``
    those with a span of that name around them (on any thread)."""
    recs = list(_RECORDS)
    covered: typing.Dict[int, int] = collections.defaultdict(int)
    for r in recs:
        if r.parent is not None and r.parent.thread == r.thread:
            covered[id(r.parent)] += r.end_ns - r.start_ns
    sums: typing.Dict[str, typing.List[int]] = {}
    for r in recs:
        if thread is not None and r.thread != thread:
            continue
        if within is not None and not _within(r, within):
            continue
        dur = r.end_ns - r.start_ns
        s = sums.setdefault(r.name, [0, 0, 0])
        s[0] += 1
        s[1] += dur
        s[2] += dur - covered[id(r)]
    return {k: Total(c, ns / 1e9, own / 1e9) for k, (c, ns, own)
            in sums.items()}


def _add_side_spans(path: str, side: typing.Sequence[Record]) -> None:
    """Append spans of threads the profiler did not trace to a Chrome
    trace, one row a thread, on the trace's own time base."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = data.setdefault("traceEvents", [])
    for tid in sorted({r.thread for r in side}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"thread {tid} (pcc spans)"}})
    for r in side:
        events.append({
            "ph": "X", "cat": "pcc_span", "name": r.name, "pid": pid,
            "tid": r.thread, "ts": (r.start_ns - base) / 1e3,
            "dur": (r.end_ns - r.start_ns) / 1e3,
            "args": {"pair": r.pair,
                     "parent": r.parent.name if r.parent else None}})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: typing.Optional[str]):
    """torch.profiler trace of the block (CPU activity, and CUDA when a
    card is present), written on exit as ``trace-<time>-<pid>.json`` into
    ``log_dir`` (created if missing), with the spans of the block's side
    threads (the OBB thread, prefetch workers) on rows of their own; a
    no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    me, t0 = threading.get_native_id(), time.time_ns()
    with profile(activities=activities) as prof:
        yield
    name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    side = [r for r in _RECORDS if r.start_ns >= t0 and r.thread != me]
    if side:
        _add_side_spans(path, side)
