"""The readers of the port's spans and counters on a synthetic recorder:
each metric's value from a window of two pairs, and None where the port
has no recorder or its ``pcc.pair`` count is not the window's pairs."""
import pytest

from open_pcc_metric_tpu_torch.utils import profiling
from open_pcc_metric_tpu_torch.utils.profiling import Record
from portbench import harness, spans

MAN = harness.Manifest()
MS = 1_000_000  # ns
NAMES = ("io.load_ms_per_pair", "fused.host_ms_per_pair",
         "fused.syncs_per_pair", "obb.wait_ms_per_pair")


def _pair_records(pair, t0, main, side):
    """One CLI call's spans: two loads on the main thread, an evaluation
    with two readbacks and an OBB wait, the OBB thread's hull beside it
    with a readback of its own."""
    p = Record("pcc.pair", None, pair, main, t0, t0 + 100 * MS)
    load_a = Record("pcc.load", p, pair, main, t0, t0 + 10 * MS)
    parse = Record("pcc.parse", load_a, pair, main, t0, t0 + 6 * MS)
    load_b = Record("pcc.load", p, pair, main, t0 + 10 * MS, t0 + 15 * MS)
    ev = Record("pcc.evaluate", p, pair, main, t0 + 20 * MS, t0 + 90 * MS)
    rb1 = Record("pcc.readback", ev, pair, main, t0 + 30 * MS,
                 t0 + 32 * MS)
    wait = Record("pcc.obb_wait", ev, pair, main, t0 + 40 * MS,
                  t0 + 80 * MS)
    fin = Record("pcc.finalize", ev, pair, main, t0 + 80 * MS, t0 + 81 * MS)
    rb2 = Record("pcc.readback", fin, pair, main, t0 + 80 * MS,
                 t0 + 80 * MS + MS // 2)
    obb = Record("pcc.obb", ev, pair, side, t0 + 21 * MS, t0 + 79 * MS)
    rb3 = Record("pcc.readback", obb, pair, side, t0 + 70 * MS,
                 t0 + 71 * MS)
    return [parse, load_a, load_b, rb1, wait, rb2, fin, rb3, obb, ev, p]


@pytest.fixture
def run(monkeypatch):
    main = spans.main_thread()
    recs = (_pair_records(0, 0, main, main + 1)
            + _pair_records(1, 200 * MS, main, main + 2))
    monkeypatch.setattr(profiling, "_RECORDS", recs)
    r = harness.Run("opm-vox10-cli-pairs", {}, {}, 1, 1.0, {})
    r.calls = [harness.Call(0.1, [harness.Pair("q", 10, 10, 0.1, {}, None,
                                               True)], [])
               for _ in range(2)]
    return r


def _read(name, run):
    return MAN.reader(name).read(run)


def test_readers_on_a_synthetic_recorder(run):
    assert _read("io.load_ms_per_pair", run) == pytest.approx(15.0)
    # 70 ms of evaluation less 2 + 0.5 ms of readbacks and 40 ms of wait
    assert _read("fused.host_ms_per_pair", run) == pytest.approx(27.5)
    assert _read("fused.syncs_per_pair", run) == pytest.approx(3.0)
    assert _read("obb.wait_ms_per_pair", run) == pytest.approx(40.0)


def test_readers_read_none_when_the_pairs_differ(run):
    run.calls.append(run.calls[0])
    assert [_read(n, run) for n in NAMES] == [None] * 4


def test_readers_read_none_without_the_ports_recorder(run, monkeypatch):
    monkeypatch.delattr(profiling, "totals")
    assert [_read(n, run) for n in NAMES] == [None] * 4


def test_readers_read_none_on_an_empty_recorder(run, monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDS", [])
    assert [_read(n, run) for n in NAMES] == [None] * 4


def test_a_pair_without_waits_or_readbacks_reads_zero(run, monkeypatch):
    keep = [r for r in profiling._RECORDS
            if r.name not in ("pcc.readback", "pcc.obb_wait")]
    monkeypatch.setattr(profiling, "_RECORDS", keep)
    assert _read("fused.syncs_per_pair", run) == 0.0
    assert _read("obb.wait_ms_per_pair", run) == 0.0
    assert _read("fused.host_ms_per_pair", run) == pytest.approx(70.0)


@pytest.mark.parametrize("name", NAMES)
def test_entries_name_their_readers(name):
    (entry,) = [m for m in MAN.data["per_layer"] if m["name"] == name]
    reader = MAN.reader(name)
    assert (entry["layer"], entry["moves"], entry["unit"]) == (
        reader.LAYER, reader.MOVES, reader.UNIT)
    assert entry["source"] == ("program_counter" if "syncs" in name
                               else "program_span")
