"""BENCHMARK.json against the contract's rules, and every name in it
against the files the harness finds by that name."""
import json
import os
import re

import pytest

from portbench import harness
from portbench.judge import PARTS

MAN = harness.Manifest()
D = MAN.data
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(D) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert 1 <= len(D["paths"]) <= 16 and all(PATH.match(p)
                                              for p in D["paths"])
    assert 1 <= len(D["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in D["command"])


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_keys_names_and_lines(kind):
    entries = D[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = set(e) - ENTRY_KEYS[kind]
        assert extra <= {"workloads"} and not (
            extra and kind in ("configs", "workloads")), (e["name"], extra)
        assert ENTRY_KEYS[kind] <= set(e)
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and kind != "end_to_end" and kind != "per_layer":
                assert _line(e[key])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        if kind == "per_layer":
            assert _line(e["layer"])


def test_metric_names_units_and_bounds():
    names = {m["name"] for m in D["end_to_end"] + D["per_layer"]}
    assert len(names) == len(D["end_to_end"]) + len(D["per_layer"])
    assert "setup_s" in {m["name"] for m in D["end_to_end"]}
    for m in D["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in D["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = D["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_workloads_name_configs_traffic_drivers_and_limits():
    configs = {c["name"] for c in D["configs"]}
    pairs = set()
    for w in D["workloads"]:
        assert w["config"] in configs
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = MAN.traffic(w["traffic"])
        assert os.path.exists(os.path.join(
            MAN.bench, "drivers", traffic["driver"] + ".py"))
        assert hasattr(MAN.driver(traffic["driver"]), "Driver")
        limits = MAN.limits(w["name"])
        assert set(PARTS) <= set(limits) and limits["judged_pairs"] >= 1
    assert configs == {w["config"] for w in D["workloads"]}
    four = sum(w["chips"] == 4 for w in D["workloads"])
    assert four <= max(1, len(D["workloads"]) // 4)


def test_config_files_hold_their_reduced_keys():
    files = set()
    for c in D["configs"]:
        assert c["file"].startswith(D["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        data = MAN.config(c["name"])
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        for k in c["reduced"]:
            assert k in data and k in data["published"]
            assert not k.endswith(("_dim", "_rank"))


def test_metrics_have_readers_and_move_reported_metrics():
    e2e = {m["name"]: m for m in D["end_to_end"]}
    cells = {w["name"] for w in D["workloads"]}
    for m in D["end_to_end"] + D["per_layer"]:
        reader = MAN.reader(m["name"])
        assert callable(reader.read) and reader.UNIT == m["unit"]
        assert set(m.get("workloads", cells)) <= cells
    for m in D["per_layer"]:
        reader = MAN.reader(m["name"])
        assert m["moves"] in e2e
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        for cell in m.get("workloads", cells):
            assert m["moves"] in {x["name"]
                                  for x in MAN.metrics(cell, "end_to_end")}
    for cell in cells:
        reported = MAN.metrics(cell, "end_to_end")
        assert "setup_s" in {x["name"] for x in reported}
        assert len(reported) >= 2 and MAN.metrics(cell, "per_layer")


def test_layers_of_one_name_are_spelt_alike():
    by_prefix = {}
    for m in D["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_kernel_lists_are_disjoint():
    seen = {}
    for m in D["per_layer"]:
        for k in getattr(MAN.reader(m["name"]), "KERNELS", ()):
            assert k not in seen, (k, seen.get(k), m["name"])
            seen[k] = m["name"]
    assert seen


def test_files_under_paths_are_named_from_name_characters():
    for path in D["paths"]:
        for dirpath, dirnames, filenames in os.walk(
                os.path.join(harness.ROOT, path)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in filenames:
                rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
                assert PATH.match(rel), rel
                assert all(NAME.match(part) for part in rel.split("/")), rel


def test_traffic_files_are_data():
    folder = os.path.join(MAN.bench, "traffic")
    for f in os.listdir(folder):
        assert f.endswith((".json", ".jsonl", ".toml", ".txt", ".csv"))
        with open(os.path.join(folder, f)) as fh:
            json.load(fh)
