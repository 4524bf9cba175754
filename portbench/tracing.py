"""The traced window: a ``torch.profiler`` trace of the card, reduced to
kernel times by name, the device's busy time and its idle gaps.

Only the traced run (``--trace 1``) profiles; its end-to-end numbers are
not reported. The reduction reads the profiler's raw events: each
device-side event (kernel, copy, set) is an interval, their union is the
busy time, and each gap between busy intervals is labelled with the
innermost host operation that the run's main thread was inside at the
gap's midpoint ("python" where it was in none).
"""
from __future__ import annotations

import collections
import re
import threading
import typing

_TEMPLATE = re.compile(r"<[^<>]*>")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


def kernel_base(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameter list: ``void ns::k<8>(float*)`` ->
    ``k``. A name that is no function signature (a copy, a set) stays
    whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)", "")
    while True:
        t = _TEMPLATE.sub("", s)
        if t == s:
            break
        s = t
    head = s.split("(", 1)[0].rsplit("::", 1)[-1].split()
    if "(" not in s or not head or not _IDENT.match(head[-1]):
        return name
    return head[-1]


class Summary(typing.NamedTuple):
    window_s: float
    busy_s: float
    kernels: typing.Dict[str, float]  # base name -> seconds
    launches: typing.Dict[str, int]
    idle: typing.Dict[str, float]  # host label -> idle seconds


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def _union(intervals):
    """Sorted, merged intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


WINDOW = "portbench.window"


def summarize(prof, window_s: float) -> Summary:
    """Reduce a finished ``torch.profiler.profile`` to a ``Summary``. The
    window was driven inside ``record_function(WINDOW)``, which marks the
    main thread."""
    from torch.autograd import DeviceType

    kernels: typing.Dict[str, float] = collections.defaultdict(float)
    launches: typing.Dict[str, int] = collections.defaultdict(int)
    device, host = [], []
    events = list(prof.profiler.kineto_results.events())
    main_thread = next((e.start_thread_id() for e in events
                        if e.name() == WINDOW), None)
    for e in events:
        start = _ns(e, "start")
        dur = int(e.duration_ns()) if hasattr(e, "duration_ns") else int(
            e.duration_us() * 1000)
        if getattr(e, "is_user_annotation", lambda: False)():
            continue  # a host range mirrored on the device's timeline
        if e.device_type() == DeviceType.CUDA:
            device.append((start, start + dur))
            base = kernel_base(e.name())
            kernels[base] += dur / 1e9
            launches[base] += 1
        elif (e.start_thread_id() == main_thread and dur > 0
              and e.name() != WINDOW):
            host.append((start, start + dur, e.name()))
    busy = _union(device)
    busy_s = sum(e - s for s, e in busy) / 1e9
    idle: typing.Dict[str, float] = collections.defaultdict(float)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if gaps:
        host.sort(key=lambda h: (h[0], -h[1]))  # a parent before its child
        starts = [h[0] for h in host]
        mids = sorted(((g0 + g1) // 2, g1 - g0) for g0, g1 in gaps)
        stack: typing.List[tuple] = []
        j = 0
        for mid, length in mids:
            while j < len(host) and starts[j] <= mid:
                while stack and stack[-1][1] <= host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            idle[stack[-1][2] if stack else "python"] += length / 1e9
    return Summary(window_s, busy_s, dict(kernels), dict(launches),
                   dict(idle))


def top(d: typing.Dict[str, float], n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Spans:
    """Host-clock spans of the benchmark's own, from any thread."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: typing.Dict[str, typing.List[float]] = \
            collections.defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name].append(seconds)
