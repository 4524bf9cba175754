"""PyTorch port: the profiling utilities and the CLI's --timings and
--trace-dir, against the JAX package's.

``utils.profiling`` (``Timer``, ``mpoints_per_sec``, ``trace`` on
torch.profiler) and ``utils.logging`` (``get_logger``) are the port's
counterparts of the JAX package's modules of the same names: the same
inputs (a scripted clock) give the same stage times and rates. The CLI
prints the JAX CLI's timing line to stderr and writes a trace file, here
on the CPU (``--device cpu``).
"""
import json
import logging
import os
import re
import time

import numpy as np
import pytest

from open_pcc_metric_tpu_torch.handler import main as cli_main
from open_pcc_metric_tpu_torch.io.loaders import write_ply
from open_pcc_metric_tpu_torch.utils import logging as port_logging
from open_pcc_metric_tpu_torch.utils import profiling

TIMING_LINE = re.compile(
    r"^evaluated (\d+)\+(\d+) points in (\d+\.\d{3})s "
    r"\((\d+\.\d{3}) Mpoints/s\)$")


def _clock(monkeypatch, ticks):
    """time.perf_counter returns ``ticks`` in turn."""
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def _stages(mod):
    t = mod.Timer()
    for name in ("load", "nn", "load", "stats"):
        with t.stage(name):
            pass
    return t.times, t.total()


def test_timer_and_rate_match_jax(monkeypatch):
    from open_pcc_metric_tpu.utils import profiling as jax_profiling

    ticks = [0.0, 0.25, 1.0, 3.5, 4.0, 4.125, 10.0, 10.0625]
    _clock(monkeypatch, ticks)
    got = _stages(profiling)
    _clock(monkeypatch, ticks)
    want = _stages(jax_profiling)
    assert got == want
    assert got[0] == {"load": 0.375, "nn": 2.5, "stats": 0.0625}
    for n, s in ((1_275_774, 0.0122), (10, 1e-9), (5, 0.0), (5, -1.0)):
        assert profiling.mpoints_per_sec(n, s) == jax_profiling.mpoints_per_sec(
            n, s)


def test_trace_none_is_a_noop(tmp_path):
    with profiling.trace(None):
        x = sum(range(10))
    assert x == 45 and os.listdir(tmp_path) == []


def test_get_logger_attaches_one_handler():
    from open_pcc_metric_tpu.utils import logging as jax_logging

    name = "pcc_port_test_logger"
    a = port_logging.get_logger(name)
    assert port_logging.get_logger(name) is a and len(a.handlers) == 1
    assert a.level == logging.INFO and not a.propagate
    j = jax_logging.get_logger(name + "_jax")
    assert (a.handlers[0].formatter._fmt == j.handlers[0].formatter._fmt)


@pytest.fixture(scope="module")
def ply_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("clouds")
    rng = np.random.default_rng(7)
    pts = np.unique(rng.integers(0, 64, (600, 3)), axis=0).astype(float)
    op, rp = str(d / "o.ply"), str(d / "r.ply")
    write_ply(op, pts)
    write_ply(rp, pts + rng.integers(-1, 2, pts.shape))
    return op, rp, len(pts)


def test_cli_timings_line_on_stderr(ply_pair, capsys):
    op, rp, n = ply_pair
    flags = ["--ocloud", op, "--pcloud", rp, "--csv", "--device", "cpu"]
    assert cli_main(flags + ["--timings"]) == 0
    out = capsys.readouterr()
    lines = out.err.strip().splitlines()
    m = TIMING_LINE.match(lines[-1])
    assert m, out.err
    assert (int(m.group(1)), int(m.group(2))) == (n, n)
    assert float(m.group(3)) > 0
    table = out.out
    assert cli_main(flags) == 0  # the table is the same, no timing line
    again = capsys.readouterr()
    assert again.out == table and "evaluated" not in again.err


def test_cli_trace_dir_writes_a_trace(ply_pair, tmp_path, capsys):
    op, rp, _ = ply_pair
    trace_dir = tmp_path / "trace"
    assert cli_main(["--ocloud", op, "--pcloud", rp, "--csv", "--device",
                     "cpu", "--trace-dir", str(trace_dir)]) == 0
    files = os.listdir(trace_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert len(capsys.readouterr().out.strip().splitlines()) == 9
