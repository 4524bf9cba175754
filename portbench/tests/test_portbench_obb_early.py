"""``obb.early_share``: the port's main-thread ``pcc.obb.early`` spans over
the window's pairs, on a synthetic recorder and under a profiler around
real ``evaluate_files`` calls on the CPU; None where no hull started at
load (a given peak, or a port without the span)."""
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from open_pcc_metric_tpu_torch.utils import profiling
from open_pcc_metric_tpu_torch.utils.profiling import Record
from portbench import harness, spans

MAN = harness.Manifest()
NAME = "obb.early_share"
MS = 1_000_000  # ns


def _run(pairs):
    r = harness.Run("opm-vox10-cli-pairs", {}, {}, 1, 1.0, {})
    r.calls = [harness.Call(0.1, [harness.Pair("q", 10, 10, 0.1, {}, None,
                                               True)], [])
               for _ in range(pairs)]
    return r


def _records(early):
    """Two calls on the main thread; the first ``early`` of them start
    their hull while the origin is parsed."""
    main, out = spans.main_thread(), []
    for pair in range(2):
        t0 = pair * 200 * MS
        p = Record("pcc.pair", None, pair, main, t0, t0 + 100 * MS)
        parse = Record("pcc.parse", p, pair, main, t0, t0 + 6 * MS)
        if pair < early:
            out.append(Record("pcc.obb.early", parse, pair, main,
                              t0 + 4 * MS, t0 + 4 * MS + 20_000))
        out += [parse, p]
    return out


@pytest.mark.parametrize("early,pairs,want", [
    (2, 2, 1.0), (1, 2, 0.5), (0, 2, None), (2, 3, None)],
    ids=["every-call", "half", "none", "pairs-differ"])
def test_reads_the_early_starts_over_the_pairs(monkeypatch, early, pairs,
                                               want):
    monkeypatch.setattr(profiling, "_RECORDS", _records(early))
    assert MAN.reader(NAME).read(_run(pairs)) == want


def test_reads_none_without_the_ports_recorder(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDS", _records(2))
    monkeypatch.delattr(profiling, "totals")
    assert MAN.reader(NAME).read(_run(2)) is None


@pytest.mark.parametrize("peak,want", [(None, 1.0), (1023.0, None)],
                         ids=["no-peak", "peak"])
def test_counts_each_evaluate_files_call(tmp_path, peak, want):
    from open_pcc_metric_tpu_torch.evaluate import evaluate_files
    from open_pcc_metric_tpu_torch.io import write_ply
    from open_pcc_metric_tpu_torch.options import CalculateOptions

    rng = np.random.default_rng(3)
    pts = np.unique(rng.integers(0, 64, (600, 3)), axis=0).astype(float)
    o, r = str(tmp_path / "o.ply"), str(tmp_path / "r.ply")
    write_ply(o, pts)
    write_ply(r, pts + rng.integers(-1, 2, pts.shape))
    options = CalculateOptions(hausdorff=True, peak=peak)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                evaluate_files(o, r, options, device="cpu")
        early = profiling.totals(thread=threading.get_native_id()).get(
            "pcc.obb.early")
        assert (early.calls if early else 0) == (2 if peak is None else 0)
        assert MAN.reader(NAME).read(_run(2)) == want
    finally:
        profiling.reset()


def test_entry_names_its_reader():
    (entry,) = [m for m in MAN.data["per_layer"] if m["name"] == NAME]
    reader = MAN.reader(NAME)
    assert (entry["layer"], entry["moves"], entry["unit"]) == (
        reader.LAYER, reader.MOVES, reader.UNIT)
    assert entry["source"] == "program_counter"
    assert entry["workloads"] == ["opm-vox10-cli-pairs"]
