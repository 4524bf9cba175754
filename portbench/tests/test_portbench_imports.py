"""Nothing the benchmark runs loads JAX or the JAX package, with
top-level module names compared whole; the reference imports nothing of
the port; the command refuses to report without a card or without the
port."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.BENCH


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded(
        ["open_pcc_metric_tpu_torch", "open_pcc_metric_tpu_torch.ops.nn",
         "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_loaded(
        ["jax.numpy", "jaxlib", "flax.linen", "open_pcc_metric_tpu.cloud"]) \
        == ["flax.linen", "jax.numpy", "jaxlib", "open_pcc_metric_tpu.cloud"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        for name in _imports(path):
            assert not name.startswith(harness.PORT), (path, name)
            assert name.split(".")[0] in ("__future__", "typing", "numpy",
                                          "scipy"), (path, name)


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "from portbench.judge import judge\n"
        "m = harness.Manifest()\n"
        "for cell in [w['name'] for w in m.data['workloads']]:\n"
        "    run = harness.execute(m, cell, 5, 0.1, True, 'cpu',\n"
        "        config_overrides={'points': 1500}, log=lambda s: None)\n"
        "    judge(run, m.limits(cell), workers=1)\n"
        "print(harness.forbidden_loaded())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _command(root):
    return [sys.executable, os.path.join(root, "portbench", "run.py"),
            "--workload", "ctc-vox10-ratesweep", "--seed", "3",
            "--seconds", "1", "--trace", "0"]


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(_command(harness.ROOT), capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == harness.EXIT_NO_CARD and out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(_command(str(tmp_path)), capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
