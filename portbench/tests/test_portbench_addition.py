"""A configuration, a traffic mix, a per-layer metric and a cell are
added as new files and BENCHMARK.json entries only, in a copy of the
benchmark, and the harness finds and runs them by name."""
import json
import shutil

from portbench import harness

METRIC = '''"""Calls a second in the window."""

LAYER = "sweep pipeline (batch.py)"
UNIT = "calls/s"
MOVES = "mpts_per_s"


def read(run):
    return len(run.calls) / run.window_s
'''


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(harness.ROOT + "/BENCHMARK.json", tmp_path)
    bench = tmp_path / "portbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    old = {p.relative_to(tmp_path): p.read_bytes()
           for p in tmp_path.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "pcerror-ctc-vox10.json")
                     .read_text())
    cfg.update(name="tiny-vox10", points=1500, qps=[6, 12], frames=1)
    (bench / "configs" / "tiny-vox10.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "ratesweep-perpair.json").write_text(json.dumps(
        {"driver": "ratesweep", "pad": "per-pair", "why": "own buckets"}))
    (bench / "metrics" / "sweep.calls_per_s.py").write_text(METRIC)
    (bench / "limits" / "tiny-sweep.json").write_text(json.dumps(
        {"d1_db": 1e-4, "d2_db": 1e-3, "color_db": 1e-4, "judged_pairs": 2}))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-vox10", "source": "test",
                           "file": "portbench/configs/tiny-vox10.json",
                           "reduced": ["frames"], "why": "test"})
    man["workloads"].append({"name": "tiny-sweep", "config": "tiny-vox10",
                             "traffic": "ratesweep-perpair", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "sweep.calls_per_s", "unit": "calls/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "sweep pipeline (batch.py)",
                             "moves": "mpts_per_s",
                             "workloads": ["tiny-sweep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    changed = [p for p, data in old.items()
               if p.name != "BENCHMARK.json" and (tmp_path / p).read_bytes()
               != data]
    assert changed == []  # nothing that was there is edited

    m = harness.Manifest(str(tmp_path), str(bench))
    run = harness.execute(m, "tiny-sweep", 9, 0.2, True, "cpu",
                          log=lambda s: None)
    assert run.traffic["pad"] == "per-pair" and run.config["points"] == 1500
    per_layer = harness.read_metrics(m, run, "per_layer")
    assert per_layer["sweep.calls_per_s"]["value"] > 0
    assert "sweep.load_wait_ms" not in per_layer  # listed for another cell
    assert set(harness.read_metrics(m, run, "end_to_end")) == {
        "mpts_per_s", "setup_s"}
