"""PyTorch port: the spans inside the port (``utils.profiling``), on the
CPU.

Tracing is on only while a torch profiler runs on the calling thread, or
where ``bind`` hands it to another thread. Off, ``span`` is one shared
no-op and the path records nothing. On, the main thread's spans reach the
profiler as ``cpu_op`` events (which label the card's idle gaps), the
recorder matches them, the OBB thread's and the sweep's prefetch spans
carry their parent and pair, ``pcc.load_wait`` equals the sweep journal's
``load_wait_s``, ``pcc.readback`` counts every readback the path makes,
and the CLI's ``--trace-dir`` writes the side threads' spans.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from open_pcc_metric_tpu_torch.batch import SweepItem, run_sweep
from open_pcc_metric_tpu_torch.evaluate import evaluate_files
from open_pcc_metric_tpu_torch.handler import main as cli_main
from open_pcc_metric_tpu_torch.io import write_ply
from open_pcc_metric_tpu_torch.ops import fused
from open_pcc_metric_tpu_torch.ops import normals as nops
from open_pcc_metric_tpu_torch.options import CalculateOptions
from open_pcc_metric_tpu_torch.utils import profiling
from open_pcc_metric_tpu_torch.utils.profiling import Record

# No peak: the minimal OBB runs on its thread beside the evaluation.
OPTS = CalculateOptions(color="ycc", hausdorff=True, point_to_plane=True,
                        d2_mode="pc_error")
ROUTES = {
    "brute": {"pcc.estimate", "pcc.sweep"},
    "pruned": {"pcc.grid", "pcc.estimate", "pcc.sweep"},
    "fold": {"pcc.fold", "pcc.grid", "pcc.estimate", "pcc.sweep"},
}
# Tensor methods that read a value back to the host (a sync on a card).
READBACKS = ("cpu", "item", "tolist", "__bool__", "__float__", "__int__")
MATCH_NS = 200_000  # 0.2 ms
ROUNDING = 5e-5  # the journal rounds its stages to 0.1 ms
# The span opens just before the journal's first clock read and closes just
# after its second: it encloses that interval, and exceeds it by its own
# clock reads and whatever the scheduler puts between them.
SPAN_SLACK = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """This module's share of torch's threads under xdist: the spans are
    held to the profiler's clock, which an oversubscribed host smears."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_recorder(monkeypatch):
    monkeypatch.setattr(fused, "_LADDER_MEMO", {})
    monkeypatch.setattr(nops, "_LADDER_MEMO", {})
    profiling.reset()
    yield
    profiling.reset()


def _cloud_pair(path, seed, n):
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, 64, (n, 3)), axis=0).astype(float)
    u8 = rng.integers(0, 256, pts.shape)
    rec = pts + rng.integers(-1, 2, pts.shape)
    rcol = np.clip(u8 + rng.integers(-3, 4, pts.shape), 0, 255)
    op, rp = str(path / f"o{seed}.ply"), str(path / f"r{seed}.ply")
    write_ply(op, pts, colors=u8 / 255.0)
    write_ply(rp, rec, colors=rcol / 255.0)
    return op, rp


@pytest.fixture(scope="module")
def plys(tmp_path_factory):
    """Three small pairs with colours, no normals (1300-1400 points: one
    1536-row bucket, above the fold's lowered threshold)."""
    d = tmp_path_factory.mktemp("tracing")
    return [_cloud_pair(d, seed, 1500) for seed in range(3)]


def _route(name, monkeypatch):
    """``evaluate_files``' backend for ``name``. The pruned estimation and
    the fold run these small clouds once the estimation's threshold is
    lowered, as the fold's tests do; "pruned" is the stepwise path, with
    the fold switched off."""
    if name == "brute":
        return "brute"
    monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    if name == "pruned":
        monkeypatch.setattr(fused, "_cold_fold_applicable",
                            lambda *a, **k: False)
    return "pruned"


def _traced(fn):
    """``fn()`` under the profiler. A long switch interval keeps the side
    threads' turns out of the few bytecodes between a span's clock reads
    and the profiler's (or the journal's)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        sys.setswitchinterval(interval)
    return out, prof


def _events(prof):
    """The profiler's ``pcc.`` events, by name, in start order."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pcc."):
            out.setdefault(e.name(), []).append(e)
    return {k: sorted(v, key=lambda e: e.start_ns()) for k, v in out.items()}


def _count_readbacks(monkeypatch):
    seen = {"n": 0}
    lock = threading.Lock()
    for name in READBACKS:
        original = getattr(torch.Tensor, name)

        def counted(self, *a, _original=original, **k):
            with lock:
                seen["n"] += 1
            return _original(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return seen


def _expected(route):
    names = {"pcc.pair", "pcc.load", "pcc.parse", "pcc.obb.early",
             "pcc.upload", "pcc.evaluate", "pcc.readback", "pcc.obb_wait",
             "pcc.finalize"}
    return names | ROUTES[route]


def test_span_off_is_the_shared_noop(plys, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("pcc.a") is profiling.span("pcc.b", pair=3)

    def fn():
        return 1

    assert profiling.bind(fn) is fn and profiling.bind(fn, pair=2) is fn

    def refuse(*a, **k):
        raise AssertionError("a CUDA call with tracing off")

    for name in ("Event", "Stream", "synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    seen = _count_readbacks(monkeypatch)
    with profiling.span("pcc.a", pair=1):
        with profiling.span("pcc.b"):
            pass
    assert seen["n"] == 0
    evaluate_files(*plys[0], OPTS, device="cpu")
    assert profiling.records() == [] and profiling.totals() == {}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_main_thread_spans_are_cpu_ops_on_the_recorders_clock(
        plys, route, monkeypatch):
    backend = _route(route, monkeypatch)
    _, prof = _traced(lambda: evaluate_files(*plys[1], OPTS, backend=backend,
                                             device="cpu"))
    main = threading.get_native_id()
    recs = [r for r in profiling.records() if r.thread == main]
    events = _events(prof)
    assert {r.name for r in recs} == set(events) == _expected(route)
    assert not any(e.is_user_annotation() for v in events.values()
                   for e in v)
    assert len({e.start_thread_id() for v in events.values()
                for e in v}) == 1
    match = {}
    for name, evs in events.items():
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        assert len(mine) == len(evs), name
        for r, e in zip(mine, evs):
            end = e.start_ns() + e.duration_ns()
            assert abs(r.start_ns - e.start_ns()) <= MATCH_NS, name
            assert abs(r.end_ns - end) <= MATCH_NS, name
            match[id(r)] = (e.start_ns(), end)
    nested = 0
    for r in recs:
        if r.parent is not None and r.parent.thread == main:
            (s, e), (ps, pe) = match[id(r)], match[id(r.parent)]
            assert ps <= s and e <= pe, (r, r.parent)
            assert r.parent.start_ns <= r.start_ns <= r.end_ns \
                <= r.parent.end_ns
            nested += 1
    assert nested == len(recs) - 1  # everything inside the one pcc.pair
    (pair,) = [r for r in recs if r.name == "pcc.pair"]
    assert {r.pair for r in recs} == {pair.pair}


def test_obb_spans_come_from_the_obb_thread(plys):
    _traced(lambda: evaluate_files(*plys[0], OPTS, device="cpu"))
    main = threading.get_native_id()
    recs = profiling.records()
    (pair,) = [r for r in recs if r.name == "pcc.pair"]
    # The hull starts while the origin's file is parsed, under the main
    # thread's pcc.obb.early.
    (early,) = [r for r in recs if r.name == "pcc.obb.early"]
    assert early.thread == main and early.parent.name == "pcc.parse"
    obb = {r.name: r for r in recs if r.name.startswith("pcc.obb")
           and r.name not in ("pcc.obb_wait", "pcc.obb.early")}
    assert set(obb) == {"pcc.obb", "pcc.obb.hull", "pcc.obb.project"}
    assert {r.thread for r in obb.values()} != {main}
    assert len({r.thread for r in obb.values()}) == 1
    assert obb["pcc.obb"].parent is early
    assert obb["pcc.obb.hull"].parent is obb["pcc.obb"]
    assert obb["pcc.obb.project"].parent is obb["pcc.obb"]
    assert {r.pair for r in obb.values()} == {pair.pair}
    t = profiling.totals()
    own = t["pcc.obb"].seconds - t["pcc.obb.hull"].seconds \
        - t["pcc.obb.project"].seconds
    assert t["pcc.obb"].self_seconds == pytest.approx(own, abs=1e-9)


def test_sweep_load_wait_and_prefetch_pairs(plys, tmp_path):
    items = [SweepItem(o, p, f"f{i}") for i, (o, p) in enumerate(plys)]
    journal, _ = _traced(lambda: run_sweep(
        items, str(tmp_path / "j.jsonl"), color_scheme="ycc",
        point_to_plane=True, d2_mode="pc_error", device="cpu"))
    assert all("error" not in r for r in journal)
    main = threading.get_native_id()
    recs = profiling.records()
    (sweep,) = [r for r in recs if r.name == "pcc.run_sweep"]
    pairs = [r for r in recs if r.name == "pcc.pair"]
    assert [p.parent for p in pairs] == [sweep] * 3
    waits = {r.pair: r for r in recs if r.name == "pcc.load_wait"}
    assert {r.thread for r in waits.values()} == {main}
    for p, rec in zip(pairs, journal):
        wait = waits[p.pair]
        assert wait.parent is p
        got = (wait.end_ns - wait.start_ns) / 1e9
        want = rec["stages"]["load_wait_s"]
        assert want - ROUNDING <= got <= want + ROUNDING + SPAN_SLACK, \
            (rec["tag"], got, want)
    t = profiling.totals(thread=main)
    assert t["pcc.load_wait"].calls == 3
    want = sum(r["stages"]["load_wait_s"] for r in journal)
    assert want - 3 * ROUNDING <= t["pcc.load_wait"].seconds \
        <= want + 3 * (ROUNDING + SPAN_SLACK)
    # Every pair's prefetch parses its own two files under its own id,
    # whichever pair was running when it was submitted.
    side = [r for r in recs if r.thread != main]
    assert {r.name for r in side} >= {"pcc.load", "pcc.parse", "pcc.upload"}
    for p in pairs:
        parses = [r for r in side if r.name == "pcc.parse"
                  and r.pair == p.pair]
        assert len(parses) == 2 and all(r.parent.name == "pcc.load"
                                        for r in parses)
    for r in side:
        top = r
        while top.parent is not None:
            top = top.parent
        assert top is sweep


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_readback_spans_count_every_readback(plys, route, monkeypatch):
    backend = _route(route, monkeypatch)
    seen = _count_readbacks(monkeypatch)
    _traced(lambda: evaluate_files(*plys[2], OPTS, backend=backend,
                                  device="cpu"))
    t = profiling.totals()
    assert t["pcc.readback"].calls == seen["n"] >= 1
    syncs = {"brute": 1, "pruned": 3, "fold": 1}[route]
    main = profiling.totals(thread=threading.get_native_id())
    assert main["pcc.readback"].calls == syncs


def test_cli_trace_dir_writes_the_obb_threads_spans(plys, tmp_path, capsys):
    op, rp = plys[0]
    trace_dir = tmp_path / "trace"
    assert cli_main(["--ocloud", op, "--pcloud", rp, "--csv", "--device",
                     "cpu", "--trace-dir", str(trace_dir)]) == 0
    capsys.readouterr()
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        events = json.load(f)["traceEvents"]
    main = threading.get_native_id()
    spans = {e["name"]: e for e in events if e.get("ph") == "X"
             and e["name"].startswith("pcc.")}
    assert spans["pcc.evaluate"]["tid"] == main
    hull = spans["pcc.obb.hull"]
    assert hull["tid"] != main and hull["pid"] == os.getpid()
    assert hull["args"]["parent"] == "pcc.obb"
    # the hull starts while the origin is read and ends before the table
    parse = min((e for e in events if e.get("ph") == "X"
                 and e["name"] == "pcc.parse"), key=lambda e: e["ts"])
    ev = spans["pcc.evaluate"]
    assert parse["ts"] <= hull["ts"] <= ev["ts"] + ev["dur"]
    assert any(e.get("ph") == "M" and e.get("tid") == hull["tid"]
               for e in events)


def test_totals_sums_self_time_threads_and_ancestry(monkeypatch):
    ev = Record("pcc.evaluate", None, 7, thread=1, start_ns=0,
                end_ns=10_000)
    rb = Record("pcc.readback", ev, 7, thread=1, start_ns=1_000,
                end_ns=3_000)
    wait = Record("pcc.obb_wait", ev, 7, thread=1, start_ns=5_000,
                  end_ns=9_000)
    obb = Record("pcc.obb", ev, 7, thread=2, start_ns=500, end_ns=8_500)
    far = Record("pcc.readback", obb, 7, thread=2, start_ns=600,
                 end_ns=700)
    stray = Record("pcc.readback", None, None, thread=1, start_ns=20_000,
                   end_ns=20_500)
    monkeypatch.setattr(profiling, "_RECORDS",
                        [rb, wait, far, obb, ev, stray])
    t = profiling.totals()
    assert t["pcc.evaluate"] == (1, 1e-5, 4e-6)  # the OBB thread's own
    assert t["pcc.obb"] == (1, 8e-6, pytest.approx(7.9e-6))
    assert t["pcc.readback"] == (3, pytest.approx(2.6e-6),
                                 pytest.approx(2.6e-6))
    assert profiling.totals(thread=1)["pcc.readback"].calls == 2
    inside = profiling.totals(thread=1, within="pcc.evaluate")
    assert set(inside) == {"pcc.readback", "pcc.obb_wait"}
    assert inside["pcc.readback"] == (1, 2e-6, 2e-6)
    assert profiling.totals(within="pcc.evaluate")["pcc.readback"].calls == 2


def test_bind_hands_the_context_to_another_thread():
    out = {}

    def side():
        out["enabled"] = torch.autograd._profiler_enabled()
        with profiling.span("pcc.side"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("pcc.top", pair=profiling.new_pair()) as top:
            for fn in (profiling.bind(side), profiling.bind(side, pair=99),
                       side):
                th = threading.Thread(target=fn)
                th.start()
                th.join()
    sides = [r for r in profiling.records() if r.name == "pcc.side"]
    assert out["enabled"] is False  # the profiler does not see the thread
    assert [(r.parent, r.pair) for r in sides] == [(top, top.pair),
                                                   (top, 99)]
    assert profiling.records()[-1] is top
