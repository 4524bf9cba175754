"""PyTorch port: the sweep pipeline (``batch.run_sweep``) against the JAX
package's.

One JAX sweep and one port sweep (``device="cpu"``) run once per module
over the same three seeded frames under ``pad="common"`` (one shape for
JAX to compile), with colour and estimated normals. The port's journal is
held against JAX's: the same record and stage keys, PSNRs within 1e-4 dB
and every other value within 1e-5 relative, and each frame against the
float64 oracle. The colour Hausdorff values are held through their PSNRs
(1e-4 dB, 2.3e-5 relative on the value): each is the square of a
difference of two float32 YCC values near 0.5 that differ by a few 8-bit
levels, so one ulp in either moves it by ~1e-5 relative, and XLA:CPU
contracts JAX's multiply-adds into FMAs where the port rounds each. The
other tests mirror ``tests/test_batch.py``'s
single-device tests: resume, per-frame errors, pairing, the common pad
against per-pair buckets, the counters and the CLI (argparse here).
"""
import json
import shutil

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch import batch
from open_pcc_metric_tpu_torch.batch import (SweepItem, pairs_from_dirs,
                                             pairs_from_manifest, run_sweep)
from open_pcc_metric_tpu_torch.io import write_ply
from open_pcc_metric_tpu_torch.utils.profiling import Timer, mpoints_per_sec

from test_torch_fused import PSNR_TOL, _assert_stats_close
from test_torch_refine import jax_on_cpu

SWEEP_KW = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """tests/test_batch.py's three frames: integer points in [0, 256)^3,
    the processed frame moved by -1..1 per axis, 8-bit colours (here moved
    by -3..3 levels in the processed frame, so the colour PSNRs are
    finite)."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    odir, pdir = root / "orig", root / "proc"
    odir.mkdir()
    pdir.mkdir()
    clouds = []
    for f in range(3):
        pts = np.unique(rng.integers(0, 256, (600 + 100 * f, 3)), axis=0
                        ).astype(float)
        rec = pts + rng.integers(-1, 2, pts.shape)
        u8 = rng.integers(0, 256, pts.shape)
        colors = u8 / 255.0
        rcol = np.clip(u8 + rng.integers(-3, 4, pts.shape), 0, 255) / 255.0
        write_ply(odir / f"frame{f}.ply", pts, colors=colors)
        write_ply(pdir / f"frame{f}.ply", rec, colors=rcol)
        clouds.append((pts, rec, colors, rcol))
    return root, odir, pdir, clouds


@pytest.fixture(scope="module")
def sweeps(frames):
    """(JAX records, port records, port journal path) of one sweep each."""
    jax_on_cpu()
    from open_pcc_metric_tpu.batch import pairs_from_dirs as jpairs
    from open_pcc_metric_tpu.batch import run_sweep as jsweep

    root, odir, pdir, _ = frames
    want = jsweep(jpairs(str(odir), str(pdir)), str(root / "jax.jsonl"),
                  pad="common", **SWEEP_KW)
    journal = root / "port.jsonl"
    got = run_sweep(pairs_from_dirs(str(odir), str(pdir)), str(journal),
                    pad="common", device="cpu", **SWEEP_KW)
    return want, got, journal


COLOUR_HAUSDORFF = ("color_hausdorff_left", "color_hausdorff_right",
                    "color_hausdorff_sym")


def _metrics_close(got, want):
    """The port's metrics against JAX's: the colour Hausdorff values
    through their PSNRs (module docstring)."""
    assert set(got) == set(want)
    for key in want:
        assert np.all(np.isfinite(np.asarray(got[key], np.float64))), key
    _assert_stats_close(got, want,
                        [k for k in want if k not in COLOUR_HAUSDORFF])


def test_sweep_journal_matches_jax_and_oracle(frames, sweeps):
    _, _, _, clouds = frames
    want, got, journal = sweeps
    assert [r["tag"] for r in got] == [r["tag"] for r in want]
    import oracle

    for (pts, rec, col, rcol), g, w in zip(clouds, got, want):
        assert "error" not in g, g.get("error")
        _metrics_close(g["metrics"], w["metrics"])
        ref = oracle.full_metrics(pts, rec, col, rcol, color_scheme="ycc",
                                  hausdorff=True)
        _assert_stats_close(g["metrics"], ref, [
            "geo_mse_left", "geo_mse_right", "geo_psnr_sym",
            "geo_hausdorff_sym", "color_psnr_sym",
            "color_hausdorff_psnr_left", "color_hausdorff_psnr_right"])
    lines = [json.loads(line) for line in journal.read_text().splitlines()]
    assert lines == got


def test_record_keys_match_jax(sweeps):
    want, got, _ = sweeps
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert set(g["stages"]) == set(w["stages"]) == {
            "parse_s", "upload_s", "load_wait_s", "eval_s"}
        assert g["wall_s"] > 0 and g["mpoints_per_sec"] > 0
        assert (g["ocloud"], g["pcloud"]) == (w["ocloud"], w["pcloud"])


def test_sweep_resume_skips_done(frames, sweeps, tmp_path):
    _, odir, pdir, _ = frames
    _, got, journal = sweeps
    items = pairs_from_dirs(str(odir), str(pdir))
    part = tmp_path / "out.jsonl"
    part.write_text("".join(journal.read_text().splitlines(True)[:2]))
    results = run_sweep(items, str(part), device="cpu", **SWEEP_KW)
    lines = part.read_text().splitlines()
    assert len(lines) == 3  # only frame2 appended on the second run
    assert results[:2] == got[:2]
    assert results[2]["metrics"] == got[2]["metrics"]


def test_sweep_error_skip_and_log(frames, sweeps, tmp_path):
    """A missing file gives an error record and the sweep goes on; the
    error record does not count as done on resume."""
    _, odir, pdir, _ = frames
    _, got, journal = sweeps
    items = pairs_from_dirs(str(odir), str(pdir))
    items.insert(1, SweepItem("/nonexistent.ply", "/nonexistent.ply", "bad"))
    part = tmp_path / "out.jsonl"
    done = journal.read_text().splitlines(True)
    part.write_text(done[0] + done[2])  # frames 0 and 2 are done
    results = run_sweep(items, str(part), device="cpu", **SWEEP_KW)
    assert [("error" in r) for r in results] == [False, True, False, False]
    assert results[1]["error"].startswith("FileNotFoundError")
    assert results[2]["metrics"] == got[1]["metrics"]
    assert len(part.read_text().splitlines()) == 4
    again = run_sweep(items[:2], str(part), device="cpu", **SWEEP_KW)
    assert again[0] == results[0] and "error" in again[1]
    assert len(part.read_text().splitlines()) == 5


def test_pairing_matches_jax(frames, tmp_path):
    jax_on_cpu()
    from open_pcc_metric_tpu.batch import pairs_from_dirs as jdirs
    from open_pcc_metric_tpu.batch import pairs_from_manifest as jmanifest

    _, odir, pdir, _ = frames
    m = tmp_path / "m.csv"
    m.write_text("ocloud,pcloud,tag\n/a.ply,/b.ply,x\n# note\n\n"
                 "/c.ply, /d.ply\n")
    got = pairs_from_manifest(str(m))
    assert [it.tag for it in got] == ["x", "d.ply"]
    assert [vars(it) for it in got] == [vars(it) for it in jmanifest(str(m))]
    pdir2 = tmp_path / "proc"
    shutil.copytree(pdir, pdir2)
    (pdir2 / "frame1.ply").unlink()  # no counterpart: skipped with a warning
    for p in (pdir, pdir2):
        got = pairs_from_dirs(str(odir), str(p))
        want = jdirs(str(odir), str(p))
        assert [vars(it) for it in got] == [vars(it) for it in want]
    assert [it.tag for it in got] == ["frame0.ply", "frame2.ply"]


def test_common_pad_equals_per_pair(frames, sweeps, tmp_path):
    """Per-pair buckets (768, 768, 1024 rows) give the common bucket's
    (1024 rows) results, the port's and JAX's."""
    _, odir, pdir, _ = frames
    want, got, _ = sweeps
    per = run_sweep(pairs_from_dirs(str(odir), str(pdir)),
                    str(tmp_path / "per.jsonl"), pad="per-pair",
                    device="cpu", **SWEEP_KW)
    for p, g, w in zip(per, got, want):
        for k in g["metrics"]:
            np.testing.assert_allclose(p["metrics"][k], g["metrics"][k],
                                       rtol=1e-6, err_msg=k)
        _metrics_close(p["metrics"], w["metrics"])


def test_timer_and_counters():
    jax_on_cpu()
    from open_pcc_metric_tpu.utils.profiling import \
        mpoints_per_sec as jmpoints

    t = Timer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    assert list(t.times) == ["a"] and t.total() >= 0
    assert mpoints_per_sec(2_000_000, 2.0) == 1.0
    for n, s in ((2_000_000, 2.0), (1_703_117, 0.0731), (5, 0.0)):
        assert mpoints_per_sec(n, s) == jmpoints(n, s)


def test_cli_journal_equals_run_sweep(frames, sweeps, tmp_path, capsys):
    _, odir, pdir, _ = frames
    _, got, _ = sweeps
    manifest = tmp_path / "m.csv"
    manifest.write_text("".join(f"{it.ocloud},{it.pcloud},{it.tag}\n"
                                for it in pairs_from_dirs(str(odir),
                                                          str(pdir))))
    journal = tmp_path / "cli.jsonl"
    rc = batch.main(["--manifest", str(manifest), "--journal", str(journal),
                     "--color", "ycc", "--point-to-plane", "--d2-mode",
                     "pc_error", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"3/3 frames evaluated -> {journal}"
    lines = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["metrics"] for r in lines] == [r["metrics"] for r in got]
    # A resumed CLI run evaluates nothing and appends nothing.
    assert batch.main(["--manifest", str(manifest), "--journal",
                       str(journal), "--device", "cpu"]) == 0
    assert len(journal.read_text().splitlines()) == 3
    with pytest.raises(SystemExit):  # neither a manifest nor directories
        batch.main(["--journal", str(journal), "--device", "cpu"])
    with pytest.raises(SystemExit):  # --backend from ops.nn.BACKENDS
        batch.main(["--manifest", str(manifest), "--journal", str(journal),
                    "--backend", "kdtree", "--device", "cpu"])


def test_run_sweep_without_device_needs_cuda(frames, tmp_path, monkeypatch,
                                             capsys):
    """No device named and no CUDA device: run_sweep and the cache raise,
    and the CLI's default --device cuda is a usage error."""
    _, odir, pdir, _ = frames
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = pairs_from_dirs(str(odir), str(pdir))
    journal = tmp_path / "out.jsonl"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(items, str(journal))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch._CloudCache().get(items[0].ocloud, "float32")
    with pytest.raises(SystemExit):
        batch.main(["--ocloud-dir", str(odir), "--pcloud-dir", str(pdir),
                    "--journal", str(journal)])
    assert "no CUDA device" in capsys.readouterr().err
    assert not journal.exists()


@pytest.mark.cuda
def test_cuda_sweep_matches_cpu(frames, tmp_path):
    """run_sweep on the card (thin uploads, prefetch streams, the kernels)
    gives the CPU sweep's records within the stated tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep's kernels have no CPU "
                    "mode")
    _, odir, pdir, _ = frames
    items = pairs_from_dirs(str(odir), str(pdir))
    cpu = run_sweep(items, str(tmp_path / "cpu.jsonl"), device="cpu",
                    backend="pruned", **SWEEP_KW)
    gpu = run_sweep(items, str(tmp_path / "gpu.jsonl"), device="cuda",
                    backend="pruned", **SWEEP_KW)
    for c, g in zip(cpu, gpu):
        assert "error" not in g, g.get("error")
        assert set(g["metrics"]) == set(c["metrics"])
        _assert_stats_close(g["metrics"], c["metrics"])
