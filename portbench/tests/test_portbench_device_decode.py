"""``io.device_decode_share``: the port's ``pcc.decode.device`` spans over
its ``pcc.parse`` spans on every thread, on a synthetic recorder: None
without the span (a port that decodes every file on the host), 1.0 where
every load decodes on the card, the share where only some do."""
import pytest

from open_pcc_metric_tpu_torch.utils import profiling
from open_pcc_metric_tpu_torch.utils.profiling import Record
from portbench import harness, spans

MAN = harness.Manifest()
NAME = "io.device_decode_share"
MS = 1_000_000  # ns


def _run(pairs):
    r = harness.Run("ctc-vox10-ratesweep", {}, {}, 1, 1.0, {})
    r.calls = [harness.Call(0.1, [harness.Pair("q", 10, 10, 0.1, {}, None,
                                               True)], [])
               for _ in range(pairs)]
    return r


def _records(decoded):
    """Two pairs, each loading two clouds on a side thread (a sweep's
    prefetch); the first ``decoded`` loads split their records on the
    card."""
    main, side, out, load = spans.main_thread(), spans.main_thread() + 1, \
        [], 0
    for pair in range(2):
        t0 = pair * 200 * MS
        p = Record("pcc.pair", None, pair, main, t0, t0 + 100 * MS)
        for k in range(2):
            s = t0 + k * 10 * MS
            ld = Record("pcc.load", p, pair, side, s, s + 8 * MS)
            parse = Record("pcc.parse", ld, pair, side, s, s + 5 * MS)
            up = Record("pcc.upload", ld, pair, side, s + 5 * MS, s + 8 * MS)
            if load < decoded:
                out.append(Record("pcc.decode.device", up, pair, side,
                                  s + 5 * MS, s + 7 * MS))
            out += [parse, up, ld]
            load += 1
        out.append(p)
    return out


@pytest.mark.parametrize("decoded,pairs,want", [
    (4, 2, 1.0), (3, 2, 0.75), (1, 2, 0.25), (0, 2, None), (4, 3, None)],
    ids=["every-load", "three-of-four", "one-of-four", "no-span",
         "pairs-differ"])
def test_reads_the_loads_decoded_on_the_card(monkeypatch, decoded, pairs,
                                             want):
    monkeypatch.setattr(profiling, "_RECORDS", _records(decoded))
    assert MAN.reader(NAME).read(_run(pairs)) == want


def test_reads_none_without_the_ports_recorder(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDS", _records(4))
    monkeypatch.delattr(profiling, "totals")
    assert MAN.reader(NAME).read(_run(2)) is None


def test_entry_names_its_reader():
    (entry,) = [m for m in MAN.data["per_layer"] if m["name"] == NAME]
    reader = MAN.reader(NAME)
    assert (entry["layer"], entry["moves"], entry["unit"]) == (
        reader.LAYER, reader.MOVES, reader.UNIT)
    assert entry["source"] == "program_counter"
    assert entry["workloads"] == ["ctc-vox10-ratesweep",
                                  "opm-vox10-cli-pairs"]
