"""PyTorch port: the origin's minimal-OBB hull started while its file is
read, on the CPU.

Without a user peak, ``evaluate_files`` (and the CLI) start the origin's
hull on a thread the moment its float64 points are parsed, and the origin
holds it as its pending OBB extent. The tables equal two ``load_cloud``
calls and ``evaluate_pair`` entry for entry; the hull runs once a cloud,
on a thread of its own, through ``ops.obb.minimal_obb_extent`` as looked up
at the call; a hull that raises makes the call raise; a given peak, and
``run_sweep``, start none. The staged reader hands out the points
``read_point_cloud`` returns.
"""
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from open_pcc_metric_tpu_torch.batch import SweepItem, run_sweep
from open_pcc_metric_tpu_torch.evaluate import (_load_pair, evaluate_files,
                                                evaluate_pair, load_cloud)
from open_pcc_metric_tpu_torch.io import read_point_cloud, write_pcd, write_ply
from open_pcc_metric_tpu_torch.io.loaders import _read_point_cloud_staged
from open_pcc_metric_tpu_torch.ops import fused, obb
from open_pcc_metric_tpu_torch.ops import normals as nops
from open_pcc_metric_tpu_torch.options import CalculateOptions
from open_pcc_metric_tpu_torch.utils import profiling

from test_torch_loaders import (_ascii_list_inside_vertex, _ascii_pre_vertex,
                                _binary_after_list_element,
                                _binary_list_inside_vertex, _binary_pre_vertex,
                                _faces_after_vertex)

OPTS = CalculateOptions(color="ycc", hausdorff=True, point_to_plane=True,
                        d2_mode="pc_error")
PEAK = CalculateOptions(color="ycc", hausdorff=True, point_to_plane=True,
                        d2_mode="pc_error", peak=1023.0)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.setattr(fused, "_LADDER_MEMO", {})
    monkeypatch.setattr(nops, "_LADDER_MEMO", {})
    profiling.reset()
    yield
    profiling.reset()


def _write(path, pts, colors, normals, fmt):
    if fmt == "pcd":
        write_pcd(str(path), pts, colors=colors, normals=normals)
    else:
        write_ply(str(path), pts, colors=colors, normals=normals)
    return str(path)


def _pair(tmp_path, seed, jitter=False, with_normals=False, fmt="ply",
          n=900):
    """An origin and a degraded cloud with colours (and normals where
    asked) on a 64 grid, jittered by U(-0.5, 0.5) where asked."""
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, 64, (n, 3)), axis=0).astype(float)
    rec = pts[rng.random(len(pts)) < 0.8] + rng.integers(-1, 2, (1, 3))
    if jitter:
        pts = pts + rng.uniform(-0.5, 0.5, pts.shape)
        rec = rec + rng.uniform(-0.5, 0.5, rec.shape)
    col = rng.integers(0, 256, pts.shape) / 255.0
    rcol = rng.integers(0, 256, rec.shape) / 255.0
    nrm = rcn = None
    if with_normals:
        nrm = rng.normal(size=pts.shape)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        rcn = rng.normal(size=rec.shape)
        rcn /= np.linalg.norm(rcn, axis=1, keepdims=True)
    return (_write(tmp_path / f"o{seed}.{fmt}", pts, col, nrm, fmt),
            _write(tmp_path / f"r{seed}.{fmt}", rec, rcol, rcn, fmt))


def _hull_calls(monkeypatch, fail=False):
    """Wrap ``ops.obb.minimal_obb_extent``: the thread of every call."""
    calls = []
    original = obb.minimal_obb_extent

    def wrapped(*args, **kwargs):
        calls.append(threading.get_ident())
        if fail:
            raise RuntimeError("qhull failed")
        return original(*args, **kwargs)

    monkeypatch.setattr(obb, "minimal_obb_extent", wrapped)
    return calls


def _assert_tables_equal(got, want):
    got, want = got.as_dict(), want.as_dict()
    assert list(got) == list(want)
    for key in want:
        assert np.all(np.asarray(got[key]) == np.asarray(want[key])), key


@pytest.mark.parametrize("jitter,with_normals,fmt", [
    (False, False, "ply"), (False, True, "ply"), (True, False, "ply"),
    (True, True, "ply"), (False, False, "pcd"), (True, True, "pcd")],
    ids=["int-ply", "int-ply-normals", "jitter-ply", "jitter-ply-normals",
         "int-pcd", "jitter-pcd-normals"])
def test_tables_equal_two_loads_and_evaluate_pair(tmp_path, jitter,
                                                  with_normals, fmt):
    o, r = _pair(tmp_path, 11, jitter, with_normals, fmt)
    got = evaluate_files(o, r, OPTS, device="cpu")
    a, b = load_cloud(o, device="cpu"), load_cloud(r, device="cpu")
    want = evaluate_pair(a, b, OPTS)
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("options,hulls", [(OPTS, 2), (PEAK, 0)],
                         ids=["no-peak", "peak"])
def test_one_hull_a_call_on_its_own_thread(tmp_path, monkeypatch, options,
                                           hulls):
    o, r = _pair(tmp_path, 12)
    calls = _hull_calls(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            evaluate_files(o, r, options, device="cpu")
    assert len(calls) == hulls
    assert threading.get_ident() not in calls
    main = profiling.totals(thread=threading.get_native_id())
    assert main["pcc.pair"].calls == 2
    early = main["pcc.obb.early"].calls if "pcc.obb.early" in main else 0
    assert early == hulls


def test_cli_starts_the_hull_at_load(tmp_path, monkeypatch, capsys):
    from open_pcc_metric_tpu_torch.handler import main as cli_main

    o, r = _pair(tmp_path, 13)
    calls = _hull_calls(monkeypatch)
    flags = ["--ocloud", o, "--pcloud", r, "--csv", "--device", "cpu"]
    assert cli_main(flags) == 0
    table = capsys.readouterr().out
    assert len(calls) == 1 and calls[0] != threading.get_ident()
    assert cli_main(flags + ["--peak", "63"]) == 0
    assert len(calls) == 1 and capsys.readouterr().out != table


def test_run_sweep_starts_no_early_hull(tmp_path, monkeypatch):
    pairs = [_pair(tmp_path, s) for s in (14, 15)]
    calls = _hull_calls(monkeypatch)
    items = [SweepItem(o, r, f"f{i}") for i, (o, r) in enumerate(pairs)]
    with profile(activities=[ProfilerActivity.CPU]):
        journal = run_sweep(items, str(tmp_path / "j.jsonl"),
                            color_scheme="ycc", point_to_plane=True,
                            d2_mode="pc_error", device="cpu")
    assert all("error" not in rec for rec in journal)
    assert "pcc.obb.early" not in profiling.totals()
    assert len(calls) == 2  # one a distinct origin, from the evaluation


@pytest.mark.parametrize("use", ["get", "fused", "dag"])
def test_a_pending_hull_runs_once(tmp_path, monkeypatch, use):
    o, r = _pair(tmp_path, 16)
    original = obb.minimal_obb_extent
    calls = _hull_calls(monkeypatch)
    a, b = _load_pair(o, r, "float32", "cpu", None)
    assert len(calls) <= 1 and a._obb_extent is not None
    for _ in range(2):
        if use == "get":
            a.get_obb_extent()
        else:
            evaluate_pair(a, b, OPTS, engine=use)
    extent = a.get_obb_extent()
    assert len(calls) == 1 and isinstance(extent, np.ndarray)
    assert np.array_equal(extent, original(a.valid_points(), device="cpu"))


@pytest.mark.parametrize("engine", ["fused", "dag"])
def test_a_hull_that_raises_makes_the_call_raise(tmp_path, monkeypatch,
                                                 engine):
    o, r = _pair(tmp_path, 17)
    _hull_calls(monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="qhull failed"):
        if engine == "fused":
            evaluate_files(o, r, OPTS, device="cpu")
        else:
            evaluate_pair(*_load_pair(o, r, "float32", "cpu", None), OPTS,
                          engine="dag")
    a, _ = _load_pair(o, r, "float32", "cpu", None)
    with pytest.raises(RuntimeError, match="qhull failed"):
        a.get_obb_extent()


def _written(fmt, **kw):
    def make(tmp_path):
        rng = np.random.default_rng(18)
        pts = rng.uniform(-5, 5, (50, 3))
        col = rng.integers(0, 256, pts.shape) / 255.0
        nrm = rng.normal(size=pts.shape)
        p = tmp_path / f"w.{fmt}"
        (write_pcd if fmt == "pcd" else write_ply)(
            str(p), pts, colors=col, normals=nrm, **kw)
        return p
    return make


def _layout(make):
    def write(tmp_path):
        p = tmp_path / "a.ply"
        p.write_bytes(make())
        return p
    return write


@pytest.mark.parametrize("make", [
    _layout(_ascii_pre_vertex), _layout(_binary_pre_vertex),
    _layout(_binary_after_list_element), _layout(_ascii_list_inside_vertex),
    _layout(_binary_list_inside_vertex), _layout(_faces_after_vertex),
    _written("ply"), _written("ply", binary=False), _written("pcd")],
    ids=["ascii-pre-vertex", "binary-pre-vertex", "binary-after-list",
         "ascii-list-inside", "binary-list-inside", "faces-after-vertex",
         "binary-ply", "ascii-ply", "pcd"])
def test_staged_reader_hands_out_read_point_clouds_points(tmp_path, make):
    path = make(tmp_path)
    handed = []
    raw = _read_point_cloud_staged(path, handed.append)
    want = read_point_cloud(path)
    (points,) = handed
    assert points is raw.points and points.dtype == np.float64
    for name in ("points", "colors", "normals"):
        g, w = getattr(raw, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("path", ["early", "fused"])
def test_each_call_reaches_a_module_patch_once(tmp_path, monkeypatch, path):
    """``ops.obb.minimal_obb_extent`` replaced on the module, as the
    cli-pairs benchmark cell times it: every ``evaluate_files`` call
    without a peak runs the replacement exactly once, on a thread of its
    own, whether the hull starts as the origin is read ("early") or, with
    the staged reader handing out no points, in ``fused_evaluate``
    ("fused"); the tables are the same either way."""
    import open_pcc_metric_tpu_torch.evaluate as evaluate_mod

    o, r = _pair(tmp_path, 19)
    if path == "fused":
        monkeypatch.setattr(evaluate_mod, "_read_point_cloud_staged",
                            lambda p, start: read_point_cloud(p))
    original, threads = obb.minimal_obb_extent, []

    def timed(*args, **kwargs):
        threads.append(threading.get_ident())
        return original(*args, **kwargs)

    monkeypatch.setattr(obb, "minimal_obb_extent", timed)
    with profile(activities=[ProfilerActivity.CPU]):
        tables = [evaluate_files(o, r, OPTS, device="cpu") for _ in range(3)]
    assert len(threads) == 3 and threading.get_ident() not in threads
    main = profiling.totals(thread=threading.get_native_id())
    early = main["pcc.obb.early"].calls if "pcc.obb.early" in main else 0
    assert early == (3 if path == "early" else 0)
    for table in tables[1:]:
        _assert_tables_equal(table, tables[0])
