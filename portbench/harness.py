"""Runs one cell of the benchmark once and prints its result line.

Everything a cell needs is found by name: its configuration through
``BENCHMARK.json``'s ``configs`` entry, its traffic mix in
``traffic/<traffic>.json``, the driver that mix names in
``drivers/<driver>.py``, each metric's reader in ``metrics/<name>.py`` and
the correctness limits in ``limits/<cell>.json``. A later cell, mix or
metric is added as new files and entries, without editing these.

A run: import the port, make the cell's clouds from the seed and write
them as PLY under ``TMPDIR``, warm up every shape the mix uses (all of
that is ``setup_s``), drive the mix for ``--seconds`` (traced with
``--trace 1``), read the device's memory peak, free the port's state, then
judge every table the window produced against the float64 reference and
print the metrics and the compared numbers with their limits.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import typing

from . import roofline, tracing
from .data import generate
from .judge import judge

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PORT = "open_pcc_metric_tpu_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "open_pcc_metric_tpu"})

EXIT_NO_CARD = 4
EXIT_FORBIDDEN = 5


def forbidden_loaded(names: typing.Optional[typing.Iterable[str]] = None
                     ) -> typing.List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``open_pcc_metric_tpu_torch`` is neither)."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: str = ROOT, bench: str = BENCH):
        self.root, self.bench = root, bench
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.bench, "traffic", name + ".json"))

    def driver(self, name: str):
        return load_module(os.path.join(self.bench, "drivers", name + ".py"),
                           f"portbench_driver_{name}")

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench, "metrics", metric + ".py"),
                           "portbench_metric_" + metric.replace(".", "_"))

    def limits(self, cell: str) -> dict:
        return load_json(os.path.join(self.bench, "limits", cell + ".json"))

    def metrics(self, cell: str, kind: str) -> typing.List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell in m["workloads"]]


class Pair(typing.NamedTuple):
    """One table the window produced."""

    key: str  # the degraded frame's tag
    n_a: int
    n_b: int
    wall_s: float
    table: typing.Optional[dict]
    error: typing.Optional[str]
    self_sweep: bool  # whether this table's call ran the origin's self 1-NN


class Call(typing.NamedTuple):
    """One call of the entry the driver drives."""

    wall_s: float
    pairs: typing.List[Pair]
    records: typing.List[dict]  # the sweep journal's records, if any


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    setup: typing.Dict[str, float]
    window_s: float = 0.0
    calls: typing.List[Call] = dataclasses.field(default_factory=list)
    summary: typing.Optional[tracing.Summary] = None
    spans: tracing.Spans = dataclasses.field(default_factory=tracing.Spans)
    device_name: str = ""
    memory_peak_bytes: int = 0
    groups: typing.List[generate.Group] = dataclasses.field(
        default_factory=list)
    bad: typing.Set[int] = dataclasses.field(default_factory=set)

    @property
    def pairs(self) -> typing.List[Pair]:
        return [p for c in self.calls for p in c.pairs]

    def sweeps(self) -> typing.List[roofline.Sweep]:
        """Every search the window's tables needed, from their inputs."""
        opts = self.config["options"]
        out = []
        for p in self.pairs:
            out += roofline.pair_sweeps(
                p.n_a, p.n_b, opts, self.config["reference_normals"], False,
                p.self_sweep)
        return out


def _set_cache_dirs(root: str) -> None:
    """Build and kernel caches of fixed paths inside the checkout. The
    port's own nvcc cache is ``build/torch_kernels`` beside its package."""
    cache = os.path.join(root, "build", "portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def _power_limit() -> typing.Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def execute(manifest: Manifest, cell_name: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda", t_start: float = None,
            config_overrides: typing.Optional[dict] = None,
            log=lambda s: print(s, file=sys.stderr, flush=True)) -> Run:
    """Set up, warm up and drive one cell's window; the result is the
    window's record, before any judging. The port's state is freed on
    return, after the device's memory peak is read."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.cell(cell_name)
    config = dict(manifest.config(cell["config"]), **(config_overrides or {}))
    traffic = manifest.traffic(cell["traffic"])
    driver_mod = manifest.driver(traffic["driver"])
    import torch

    importlib.import_module(PORT)
    t_imported = time.perf_counter()
    run = Run(cell_name, config, traffic, seed, seconds, {})
    work_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        run.groups = generate.make_groups(config, seed, work_dir)
        t_data = time.perf_counter()
        driver = driver_mod.Driver(config, traffic, run.groups, device,
                                   work_dir)
        driver.warm_up()
        if device == "cuda":
            torch.cuda.synchronize()
            run.device_name = torch.cuda.get_device_name(0)
        t_warm = time.perf_counter()
        run.setup = {"imports_s": t_imported - t_start,
                     "data_s": t_data - t_imported,
                     "warmup_s": t_warm - t_data,
                     "setup_s": t_warm - t_start}
        log("portbench: setup " + " ".join(
            f"{k}={v!r}" for k, v in run.setup.items()))
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
            driver.install_spans(run.spans)
        try:
            with torch.profiler.record_function(tracing.WINDOW):
                t0 = time.perf_counter()
                deadline = t0 + seconds
                while True:
                    run.calls.append(driver.step())
                    if time.perf_counter() >= deadline:
                        break
                if device == "cuda":
                    torch.cuda.synchronize()
                run.window_s = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                driver.remove_spans()
        if prof is not None:
            t = time.perf_counter()
            run.summary = tracing.summarize(prof, run.window_s)
            log(f"portbench: trace reduced in {time.perf_counter() - t!r} s")
            del prof
        if device == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        driver.close()
        del driver
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    return run


def read_metrics(manifest: Manifest, run: Run, kind: str
                 ) -> typing.Dict[str, dict]:
    """Each metric of ``kind`` that the cell reports, from its reader; a
    reader that finds nothing to read returns None, and the metric is left
    out."""
    out = {}
    for m in manifest.metrics(run.cell, kind):
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def claims(manifest: Manifest, run: Run) -> typing.Dict[str, str]:
    """Kernel base name -> the per-layer metric whose file lists it."""
    out = {}
    for m in manifest.metrics(run.cell, "per_layer"):
        for k in getattr(manifest.reader(m["name"]), "KERNELS", ()):
            out[k] = m["name"]
    return out


def breakdown(manifest: Manifest, run: Run, log) -> dict:
    """The traced window's kernels by the metric that claims them (an
    earlier line each, and ``other`` for the rest) and its idle gaps by
    the host operation under them."""
    owner = claims(manifest, run)
    by_owner: typing.Dict[str, typing.List[tuple]] = {}
    for k, s in run.summary.kernels.items():
        by_owner.setdefault(owner.get(k, "other"), []).append(
            (k, s, run.summary.launches[k]))
    for name, rows in sorted(by_owner.items()):
        rows.sort(key=lambda r: -r[1])
        log(f"portbench: kernels {name}: {sum(r[1] for r in rows)!r} s, "
            + ", ".join(f"{k} {s!r} s x{n}" for k, s, n in rows))
    labelled = {f"{owner.get(k, 'other')}:{k}": s
                for k, s in run.summary.kernels.items()}
    return {"device_ops": tracing.top(labelled),
            "idle_gaps": tracing.top(run.summary.idle)}


def main(argv=None, t_start: float = None, root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731

    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    _set_cache_dirs(root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
            f"this machine has {torch.cuda.device_count()}: no result")
        return EXIT_NO_CARD
    seed = args.seed % (1 << 63)
    run = execute(manifest, args.workload, seed, args.seconds,
                  bool(args.trace), "cuda", t_start, log=log)
    errors = [p.error for p in run.pairs if p.error]
    if errors:
        log(f"portbench: {len(errors)} tables never came; the first: "
            f"{errors[0]}")
    walls = sorted(c.wall_s for c in run.calls)
    log(f"portbench: window {run.window_s!r} s, {len(run.calls)} calls, "
        f"{len(run.pairs)} pairs; call s min {walls[0]!r} median "
        f"{walls[len(walls) // 2]!r} max {walls[-1]!r}")
    t = time.perf_counter()
    verdict = judge(run, manifest.limits(args.workload))
    run.bad = verdict.bad
    log(f"portbench: reference took {time.perf_counter() - t!r} s over "
        f"{verdict.judged} distinct pairs")
    result = {"correct": verdict.correct, "attempted": len(run.pairs),
              "failed": len(verdict.bad),
              "metrics": {}, "device": {
                  "platform": "gpu", "kind": run.device_name,
                  "count": cell["chips"],
                  "memory_peak_bytes": run.memory_peak_bytes}}
    card = _power_limit()
    if card:
        result["device"]["power_limit"] = card
        log(f"portbench: card {card}")
    if args.trace:
        result["metrics"] = read_metrics(manifest, run, "per_layer")
        result["device"]["busy_s"] = run.summary.busy_s
        result["device"]["window_s"] = run.summary.window_s
        result["breakdown"] = breakdown(manifest, run, log)
    else:
        result["metrics"] = read_metrics(manifest, run, "end_to_end")
    result["checks"] = verdict.checks
    found = forbidden_loaded()
    if found:
        log("portbench: JAX or the JAX package was loaded: "
            + ", ".join(found) + ": no result")
        return EXIT_FORBIDDEN
    for name, c in verdict.checks.items():
        log(f"portbench: check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
