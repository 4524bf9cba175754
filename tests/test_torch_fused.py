"""PyTorch port: the fused pair evaluation, goldens, CLI and import hygiene.

``fused_evaluate`` of the port is held against the JAX package's
``fused_evaluate(backend="pruned")`` on the same numpy clouds: PSNRs within
1e-4 dB, every other value within 1e-5 relative. The NN results are exact
on both sides; the tolerance is for float32 sums taken in another order.
It also reproduces all five frozen float64 goldens at the bars of
tests/test_goldens.py.
"""
import ast
import csv
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud, synthetic_voxel_pair
from open_pcc_metric_tpu_torch.evaluate import evaluate_pair
from open_pcc_metric_tpu_torch.handler import main as cli_main
from open_pcc_metric_tpu_torch.io import write_ply
from open_pcc_metric_tpu_torch.ops.fused import boundary_stats, fused_evaluate
from open_pcc_metric_tpu_torch.options import CalculateOptions

from test_torch_refine import jax_on_cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "open_pcc_metric_tpu_torch")
PSNR_TOL = 1e-4  # dB, the repo's accuracy bar
REL_TOL = 1e-5


def _pair_arrays(seed, n=3000):
    """A voxelised surface pair with colours and normals; the degraded
    cloud has at least as many points (reference D2 pairs by position)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(4 * n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts0 = np.unique(np.round(v * 60.0 + 64.0), axis=0)[:n]
    pts1 = np.unique(np.concatenate(
        [pts0 + rng.integers(-1, 2, pts0.shape), pts0[: n // 5] + 3.0]), axis=0)

    def attrs(p):
        nrm = (p - 64.0) / np.linalg.norm(p - 64.0, axis=1, keepdims=True)
        col = np.clip(np.round(255 * (0.5 + 0.5 * np.sin(p / 9.0))
                               + rng.integers(-3, 4, p.shape)) / 255.0, 0, 1)
        return col, nrm

    return (pts0, *attrs(pts0)), (pts1, *attrs(pts1))


def _assert_stats_close(got, want, keys=None):
    for key in keys or want:
        w = np.asarray(want[key], dtype=np.float64)
        g = np.asarray(got[key], dtype=np.float64)
        if "psnr" in key:
            assert np.max(np.abs(g - w)) <= PSNR_TOL, (key, g, w)
        else:
            rel = np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-12))
            assert rel <= REL_TOL, (key, g, w)


@pytest.mark.parametrize("d2_mode", ["pc_error", "reference"])
def test_fused_matches_jax(d2_mode):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused

    o, r = _pair_arrays(1)
    assert o[0].shape[0] <= r[0].shape[0]
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode=d2_mode)
    ja = JCloud.from_numpy(*o, dtype=jnp.float32, thin=False)
    jb = JCloud.from_numpy(*r, dtype=jnp.float32, thin=False)
    want = jfused(ja, jb, backend="pruned", **kw)
    a = Cloud.from_numpy(*o, device="cpu")
    b = Cloud.from_numpy(*r, device="cpu")
    got = fused_evaluate(a, b, backend="pruned", **kw)
    assert set(got) == set(want)
    _assert_stats_close(got, want)
    # the second call reuses every per-cloud cache and gives the same table
    again = fused_evaluate(a, b, backend="pruned", **kw)
    for key in got:
        np.testing.assert_array_equal(np.asarray(again[key]),
                                      np.asarray(got[key]))


def _golden_pair(cfg):
    """The port's twin of tools/make_goldens.py::_clouds_for (float64)."""
    if cfg["kind"] == "voxel":
        return synthetic_voxel_pair(cfg["n"], seed=cfg["seed"],
                                    dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(cfg["seed"])
    v = rng.normal(size=(cfg["n"], 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts0 = v * 100.0
    pts1 = pts0 + rng.normal(scale=0.3, size=pts0.shape)
    n1 = pts1 / np.linalg.norm(pts1, axis=1, keepdims=True)
    c0 = rng.uniform(0, 1, pts0.shape)
    c1 = np.clip(c0 + rng.normal(scale=0.05, size=c0.shape), 0, 1)
    a = Cloud.from_numpy(pts0, colors=c0, normals=v, dtype=torch.float64,
                         device="cpu")
    b = Cloud.from_numpy(pts1, colors=c1, normals=n1, dtype=torch.float64,
                         device="cpu")
    return a, b


with open(os.path.join(REPO, "tests", "goldens", "oracle.json")) as _f:
    GOLDENS = json.load(_f)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_fused_matches_goldens(name):
    entry = GOLDENS[name]
    cfg = entry["config"]
    a, b = _golden_pair(cfg)
    got = fused_evaluate(
        a, b, color_scheme=cfg["color"], point_to_plane=cfg["point_to_plane"],
        d2_mode=cfg["d2_mode"], peak=cfg["peak"], backend="pruned")
    for key, want in entry["metrics"].items():
        want = np.asarray(want, dtype=np.float64)
        ours = np.asarray(got[key], dtype=np.float64)
        tol = PSNR_TOL if "psnr" in key else REL_TOL
        rel = np.max(np.abs(ours - want) / np.maximum(np.abs(want), 1e-12))
        assert rel < tol, f"{name}/{key}: ours={ours} golden={want} rel={rel}"


def test_boundary_stats_match_jax():
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.ops.fused import boundary_stats as jboundary

    o, _ = _pair_arrays(2)
    a = Cloud.from_numpy(o[0], device="cpu")
    mn, mx = boundary_stats(a, backend="pruned")
    jmn, jmx = jboundary(JCloud.from_numpy(o[0], dtype=jnp.float32, thin=False),
                         backend="pruned")
    assert float(mn) == float(jmn) and float(mx) == float(jmx)
    assert boundary_stats(a)[0] is mn  # cached on the cloud


def _csv_rows(text):
    rows = list(csv.reader(io.StringIO(text.strip())))
    return rows[0], rows[1:]


def _values(cell):
    return np.array([float(x) for x in cell.strip("[]").split()])


def test_cli_rows_match_jax(tmp_path, capsys):
    jax_on_cpu()
    from click.testing import CliRunner
    from open_pcc_metric_tpu.handler import cli as jax_cli

    o, r = _pair_arrays(3)
    op, rp = str(tmp_path / "o.ply"), str(tmp_path / "r.ply")
    write_ply(op, o[0], colors=o[1], normals=o[2])
    write_ply(rp, r[0], colors=r[1], normals=r[2])
    flags = ["--ocloud", op, "--pcloud", rp, "--color", "ycc", "--hausdorff",
             "--point-to-plane", "--d2-mode", "pc_error", "--csv"]
    jres = CliRunner().invoke(jax_cli, flags)
    assert jres.exit_code == 0, jres.output
    assert cli_main(flags + ["--device", "cpu"]) == 0
    jhead, jrows = _csv_rows(jres.output)
    head, rows = _csv_rows(capsys.readouterr().out)
    assert head == jhead and len(rows) == len(jrows) == 32
    for row, jrow in zip(rows, jrows):
        assert row[:4] == jrow[:4]
        got, want = _values(row[4]), _values(jrow[4])
        if "PSNR" in row[1]:
            assert np.max(np.abs(got - want)) <= PSNR_TOL, (row, jrow)
        else:
            np.testing.assert_allclose(got, want, rtol=REL_TOL, err_msg=row[1])
    # the text table carries the same rows
    assert cli_main(flags[:-1] + ["--device", "cpu"]) == 0
    text = capsys.readouterr().out.splitlines()
    assert len(text) == 33 and text[1].split()[1] == "MinSqrtDistance"


def test_cli_device_defaults_to_cuda(tmp_path, capsys):
    """--device defaults to cuda: without a CUDA device the CLI exits
    non-zero instead of running on the CPU; with one it evaluates there."""
    p = str(tmp_path / "x.ply")
    write_ply(p, np.arange(30.0).reshape(10, 3))
    args = ["--ocloud", p, "--pcloud", p, "--csv"]
    if torch.cuda.is_available():
        assert cli_main(args) == 0
        assert len(_csv_rows(capsys.readouterr().out)[1]) == 8
        return
    with pytest.raises(SystemExit) as e:
        cli_main(args)
    assert e.value.code != 0
    assert "CUDA" in capsys.readouterr().err


def test_cli_refuses_float64_on_cuda(tmp_path, capsys):
    """--dtype float64 with a CUDA device (the default) is a usage error
    that names --device cpu, before any file is read or device sought: the
    CUDA kernels take float32 only."""
    p = str(tmp_path / "missing.ply")
    for extra in ([], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit) as e:
            cli_main(["--ocloud", p, "--pcloud", p, "--dtype", "float64"]
                     + extra)
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err


def test_unported_paths_raise():
    """The paths that once raised as unported now give the JAX package's
    numbers: backend="jnp" (the brute force) and engine="dag", on a small
    pair without normals (they are estimated); unknown names still raise."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu import CalculateOptions as JOptions
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.evaluate import evaluate_pair as jevaluate
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused

    o, r = _pair_arrays(4, n=600)
    a = Cloud.from_numpy(o[0], device="cpu")  # no normals: they are estimated
    b = Cloud.from_numpy(r[0], device="cpu")
    ja = JCloud.from_numpy(o[0], dtype=jnp.float32, thin=False)
    jb = JCloud.from_numpy(r[0], dtype=jnp.float32, thin=False)
    kw = dict(point_to_plane=True, d2_mode="pc_error")
    out = fused_evaluate(a, b, backend="jnp", **kw)
    want = jfused(ja, jb, backend="jnp", **kw)
    assert a._est_normals is not None
    _assert_stats_close(out, want, [k for k in want if "psnr" in k])
    dag = evaluate_pair(a, b, CalculateOptions(**kw), engine="dag").as_dict()
    jdag = jevaluate(ja, jb, JOptions(**kw), engine="dag").as_dict()
    assert set(dag) == set(jdag)
    for key in (k for k in jdag if "PSNR" in k[0]):
        assert abs(float(dag[key]) - float(jdag[key])) <= PSNR_TOL, key
    with pytest.raises(ValueError):
        fused_evaluate(a, b, backend="kdtree")
    with pytest.raises(ValueError):
        evaluate_pair(a, b, CalculateOptions(), engine="tree")


def test_port_imports_no_jax_pandas_click():
    banned = {"jax", "jaxlib", "pandas", "click", "open_pcc_metric_tpu"}
    for root, _, files in os.walk(PORT):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for name in names:
                    assert name.split(".")[0] not in banned, (path, name)


def test_port_runs_with_jax_blocked():
    """With ``sys.modules["jax"] = None`` any jax import would raise: the
    package imports and evaluates a tiny pair end to end on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import open_pcc_metric_tpu_torch as P\n"
        "from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate\n"
        "a, b = P.synthetic_voxel_pair(1500, seed=0, device='cpu')\n"
        "r = fused_evaluate(a, b, color_scheme='ycc')\n"
        "assert 'open_pcc_metric_tpu' not in sys.modules\n"
        "print('psnr', float(r['geo_psnr_sym']))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.split()[-1]) > 0


@pytest.mark.cuda
def test_cuda_fused_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refine kernel has no CPU mode")
    from open_pcc_metric_tpu_torch.ops.refine import refine_nn

    o, r = _pair_arrays(5)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    want = fused_evaluate(Cloud.from_numpy(*o, device="cpu"),
                          Cloud.from_numpy(*r, device="cpu"),
                          backend="pruned", **kw)
    before = refine_nn.launches
    got = fused_evaluate(Cloud.from_numpy(*o, device="cuda"),
                         Cloud.from_numpy(*r, device="cuda"),
                         backend="pruned", **kw)
    assert refine_nn.launches > before
    _assert_stats_close(got, want)
