"""The port's own spans and counters, as the traced window left them, for
the ``program_span`` and ``program_counter`` metrics that read them.

The port (``open_pcc_metric_tpu_torch.utils.profiling``) records its spans
only while a profiler runs on the thread that drives it, or on a thread
that thread handed its trace to, so after a traced run its recorder holds
the window's spans alone. Where the port has no recorder, or the
recorder's ``pcc.pair`` count is not the window's pairs, there is nothing
to read and ``totals`` gives None.
"""
from __future__ import annotations

import importlib
import threading
import typing

PROFILING = "open_pcc_metric_tpu_torch.utils.profiling"


def main_thread() -> int:
    """The native id of the thread that drives the window."""
    return threading.main_thread().native_id


def totals(run, **where) -> typing.Optional[dict]:
    """The port's ``profiling.totals(**where)`` (name -> calls, seconds,
    self seconds) after the window, or None."""
    try:
        read = importlib.import_module(PROFILING).totals
    except (ImportError, AttributeError):
        return None
    pairs = read(thread=main_thread()).get("pcc.pair")
    if not run.pairs or pairs is None or pairs.calls != len(run.pairs):
        return None
    return read(**where)


def seconds(t: dict, name: str) -> float:
    return t[name].seconds if name in t else 0.0


def calls(t: dict, name: str) -> int:
    return t[name].calls if name in t else 0
