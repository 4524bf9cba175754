"""PyTorch port: the multi-device sweep (``batch.run_sweep_sharded``) and
the sweep CLI's ``--sharded``/``--dp``.

These mirror the sharded tests of ``tests/test_batch.py`` on
tests/test_batch.py's three frames. The port's mesh is made of CPU slots
in the shape JAX's default takes on the tests' 8 virtual CPU devices,
(2, 4), so both pad every group alike. Tolerances: in float64 the sharded
records equal the port's single-device ``run_sweep``'s and JAX's
``run_sweep_sharded``'s within 1e-9 relative (test_batch.py's bar: the
ring adds its slots' partial sums in another order).
"""
import json

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch import batch
from open_pcc_metric_tpu_torch.batch import (pairs_from_dirs, run_sweep,
                                             run_sweep_sharded)
from open_pcc_metric_tpu_torch.io import write_ply
from open_pcc_metric_tpu_torch.parallel.sharded import make_mesh

from test_torch_refine import jax_on_cpu
from test_torch_sharded import _torch_threads  # noqa: F401 (autouse)

RTOL = 1e-9
KEYS = ("geo_mse_left", "geo_mse_right", "geo_psnr_sym", "min_sqrt",
        "max_sqrt", "color_psnr_sym")
YCC = dict(color_scheme="ycc", dtype="float64")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """tests/test_batch.py's frames: integer points in [0, 256)^3, the
    processed frame moved by -1..1 per axis, shared 8-bit colours."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    odir, pdir = root / "orig", root / "proc"
    odir.mkdir()
    pdir.mkdir()
    for f in range(3):
        pts = np.unique(rng.integers(0, 256, (600 + 100 * f, 3)), axis=0
                        ).astype(float)
        rec = pts + rng.integers(-1, 2, pts.shape)
        colors = rng.integers(0, 256, pts.shape) / 255.0
        write_ply(odir / f"frame{f}.ply", pts, colors=colors)
        write_ply(pdir / f"frame{f}.ply", rec, colors=colors)
    return root, odir, pdir


def _mesh(dp=2, slots=8):
    return make_mesh(devices=["cpu"] * slots, dp=dp)


@pytest.fixture(scope="module")
def ycc_sweeps(frames):
    """(single-device records, sharded records, sharded journal) of the
    port over the three frames in float64 with ycc colour."""
    root, odir, pdir = frames
    items = pairs_from_dirs(str(odir), str(pdir))
    single = run_sweep(items, str(root / "single.jsonl"), device="cpu",
                       **YCC)
    journal = root / "sharded.jsonl"
    sharded = run_sweep_sharded(items, str(journal), mesh=_mesh(), **YCC)
    return single, sharded, journal


def _assert_records(got, want, keys=KEYS, rtol=RTOL):
    by_tag = {r["tag"]: r for r in got}
    assert sorted(by_tag) == sorted(r["tag"] for r in want)
    for rec in want:
        m1, m2 = rec["metrics"], by_tag[rec["tag"]]["metrics"]
        for key in keys:
            np.testing.assert_allclose(m2[key], m1[key], rtol=rtol,
                                       err_msg=f"{rec['tag']}:{key}")


def test_sharded_sweep_matches_single(ycc_sweeps):
    single, sharded, _ = ycc_sweeps
    assert all("metrics" in r and "group_mpoints_per_sec" in r
               for r in sharded)
    _assert_records(sharded, single)


def test_sharded_sweep_matches_jax(frames, ycc_sweeps):
    """JAX's run_sweep_sharded on its default mesh, (2, 4) on the tests'
    8 virtual CPU devices: the same record keys and every metric within
    1e-9 relative."""
    jax_on_cpu()
    from open_pcc_metric_tpu.batch import pairs_from_dirs as jpairs
    from open_pcc_metric_tpu.batch import run_sweep_sharded as jsweep

    root, odir, pdir = frames
    want = jsweep(jpairs(str(odir), str(pdir)), str(root / "jax.jsonl"),
                  **YCC)
    _, got, _ = ycc_sweeps
    assert [set(r) for r in got] == [set(r) for r in want]
    _assert_records(got, want, keys=list(want[0]["metrics"]))


def test_sharded_sweep_resume_and_journal(ycc_sweeps):
    """The journal holds one record a frame, and a second sweep over it
    evaluates nothing and returns the same records."""
    _, sharded, journal = ycc_sweeps
    lines = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["tag"] for r in lines] == [r["tag"] for r in sharded]
    again = run_sweep_sharded(
        pairs_from_dirs(*[str(p) for p in (journal.parent / "orig",
                                           journal.parent / "proc")]),
        str(journal), mesh=_mesh(), **YCC)
    assert again == sharded
    assert len(journal.read_text().splitlines()) == len(sharded)


def test_sharded_sweep_estimates_normals(frames):
    """No normals in the files: the sharded sweep packs each cloud's
    single-device estimate, so D1 and D2 equal run_sweep's within 1e-9
    relative."""
    root, odir, pdir = frames
    items = pairs_from_dirs(str(odir), str(pdir))[:2]
    kw = dict(point_to_plane=True, d2_mode="pc_error", dtype="float64")
    single = run_sweep(items, str(root / "single_p2p.jsonl"), device="cpu",
                       **kw)
    sharded = run_sweep_sharded(items, str(root / "sharded_p2p.jsonl"),
                                mesh=_mesh(), **kw)
    _assert_records(sharded, single,
                    keys=("geo_mse_left", "d2_mse_left", "d2_mse_right"))


def test_sharded_sweep_brute_ring(frames, tmp_path):
    """prune=False takes the brute ring, with the pruned ring's records."""
    _, odir, pdir = frames
    items = pairs_from_dirs(str(odir), str(pdir))[:2]
    pruned = run_sweep_sharded(items, str(tmp_path / "p.jsonl"),
                               mesh=_mesh(1, 4), **YCC)
    brute = run_sweep_sharded(items, str(tmp_path / "b.jsonl"),
                              mesh=_mesh(1, 4), prune=False, **YCC)
    _assert_records(brute, pruned)


def test_cli_sharded_journal(frames, tmp_path, capsys):
    """``--sharded --dp 2 --device cpu``: a (2, 1) mesh of CPU slots, the
    journal run_sweep_sharded writes on that mesh."""
    _, odir, pdir = frames
    journal = tmp_path / "cli.jsonl"
    rc = batch.main(["--ocloud-dir", str(odir), "--pcloud-dir", str(pdir),
                     "--journal", str(journal), "--color", "ycc",
                     "--dtype", "float64", "--sharded", "--dp", "2",
                     "--device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out.strip().endswith(
        f"3/3 frames evaluated -> {journal}")
    want = run_sweep_sharded(pairs_from_dirs(str(odir), str(pdir)),
                             str(tmp_path / "api.jsonl"), mesh=_mesh(2, 2),
                             **YCC)
    got = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["metrics"] for r in got] == [r["metrics"] for r in want]


@pytest.mark.parametrize("backend", ["pruned", "brute"])
def test_cli_sharded_rejects_backend(frames, tmp_path, capsys, backend):
    """``--backend`` other than auto with ``--sharded`` is a usage error:
    the ring does not take the single-device backends."""
    _, odir, pdir = frames
    journal = tmp_path / "cli.jsonl"
    with pytest.raises(SystemExit) as exc:
        batch.main(["--ocloud-dir", str(odir), "--pcloud-dir", str(pdir),
                    "--journal", str(journal), "--sharded", "--device",
                    "cpu", "--backend", backend])
    assert exc.value.code == 2
    assert "--backend does not apply to --sharded" in capsys.readouterr().err
    assert not journal.exists()


def test_sharded_sweep_without_mesh_needs_cuda(frames, tmp_path):
    """With no mesh the sweep takes every CUDA device, and raises without
    one rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh runs there")
    _, odir, pdir = frames
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep_sharded(pairs_from_dirs(str(odir), str(pdir)),
                          str(tmp_path / "j.jsonl"))
