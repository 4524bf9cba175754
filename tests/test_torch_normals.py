"""PyTorch port: normal estimation (eigh3, the normals, the estimation
ladder) and the evaluation of clouds without normals, against the JAX
package.

Normals are unoriented and pass through float32 sums taken in another
order, so they are compared by |dot|: the 0.001-quantile over valid rows
above 0.999 (the rule of test_pruned.py's moments tests). The pruned
estimation path is reached at test sizes by lowering both packages'
``_PRUNE_THRESHOLD`` to 1024 rows. Metric tables agree within 1e-4 dB on
every PSNR.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.handler import main as cli_main
from open_pcc_metric_tpu_torch.io import write_ply
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import normals as nops
from open_pcc_metric_tpu_torch.ops.eigh3 import smallest_eigenvector_sym3
from open_pcc_metric_tpu_torch.ops.fused import boundary_stats, fused_evaluate
from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned, knn_pruned_sorted
from open_pcc_metric_tpu_torch.ops.refine import knn_moments, refine_knn

from test_torch_fused import PSNR_TOL, _assert_stats_close, _csv_rows, \
    _pair_arrays, _values
from test_torch_refine import jax_on_cpu


def _dots(x, y):
    return np.abs(np.sum(np.asarray(x, np.float64) * np.asarray(y, np.float64),
                         axis=1))


def _sym(rng, n):
    m = rng.normal(size=(n, 3, 3))
    return m + np.swapaxes(m, 1, 2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eigh3_matches_jax(dtype):
    """Random symmetric matrices: the same eigenvector as JAX and as
    LAPACK. Degenerate ones (zero, isotropic, rank-1): bit for bit the JAX
    package's, (0, 0, 1) on the first two."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.eigh3 import smallest_eigenvector_sym3 as jeig

    rng = np.random.default_rng(1)
    a = _sym(rng, 4000).astype(dtype)
    got = smallest_eigenvector_sym3(torch.from_numpy(a)).numpy()
    want = np.asarray(jeig(jnp.asarray(a)))
    assert got.dtype == want.dtype == dtype
    tight = 1e-5 if dtype == np.float32 else 1e-12
    assert np.quantile(_dots(got, want), 0.001) > 1 - tight
    lapack = np.linalg.eigh(a.astype(np.float64))[1][:, :, 0]
    assert np.quantile(_dots(got, lapack), 0.01) > 0.999
    v = rng.normal(size=(50, 3))
    degen = np.concatenate([
        np.zeros((5, 3, 3)),
        np.eye(3)[None] * rng.uniform(0.1, 10, (5, 1, 1)),
        v[:, :, None] * v[:, None, :],
    ]).astype(dtype)
    got = smallest_eigenvector_sym3(torch.from_numpy(degen)).numpy()
    want = np.asarray(jeig(jnp.asarray(degen)))
    np.testing.assert_array_equal(got[:10], np.tile([0, 0, 1], (10, 1)))
    # rank-1: a double zero eigenvalue, where the Cayley-Hamilton column
    # vanishes and the fallback gate fires on most rows, the same rows as
    # in JAX
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert np.mean(np.all(got[10:] == [0, 0, 1], axis=1)) > 0.5


def _sphere(n, seed, r=50.0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r


def test_moment_normals_match_gather_normals_and_jax():
    """normals_from_moments on the pruned k-NN's sums against
    normals_from_neighbors on its ids (the same exact sets), and against
    the JAX package's normals_from_neighbors."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.normals import normals_from_neighbors as jnfn

    c = Cloud.from_numpy(_sphere(5000, 42), pad_to=5120, device="cpu")
    g = c.get_grid()
    dk, ik, ov, mom = knn_pruned_sorted(g, g, c.n, 30, cap=16,
                                        fallback_tiles=64, with_moments=True)
    assert not bool(ov)
    inv = torch.empty_like(g.perm, dtype=torch.long)
    inv[g.perm.long()] = torch.arange(g.perm.shape[0])
    nm = nops.normals_from_moments(mom)
    ng = nops.normals_from_neighbors(c.points[g.perm.long()], inv[ik.long()],
                                     30)
    assert np.quantile(_dots(nm[: c.n], ng[: c.n]), 0.001) > 0.999
    idx, _ = knn_pruned(c.points, c.points, c.n, c.n, k=30)
    ours = nops.normals_from_neighbors(c.points, idx, 30, n_valid=c.n)
    theirs = np.asarray(jnfn(jnp.asarray(c.points.numpy()),
                             jnp.asarray(idx.numpy()), 30,
                             n_valid=jnp.asarray(c.n)))
    assert np.quantile(_dots(ours[: c.n], theirs[: c.n]), 0.001) > 0.999
    # on a sphere the PCA normal is the radial direction
    radial = c.host_points / np.linalg.norm(c.host_points, axis=1,
                                            keepdims=True)
    assert np.quantile(_dots(ours[: c.n], radial), 0.01) > 0.99


def _jax_cloud(pts, pad_to=None, colors=None):
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    return JCloud.from_numpy(pts, colors=colors, dtype=jnp.float32,
                             pad_to=pad_to, thin=False)


def test_estimate_normals_cloud_matches_jax(monkeypatch):
    """The pruned estimation (thresholds lowered): normals against JAX's,
    the boundary stats it caches equal to boundary_stats, and the rung
    ladder recorded; then a cloud with fewer than k points and a small
    cloud, which both take the brute force."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops import normals as jnops

    monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    monkeypatch.setattr(jnops, "_PRUNE_THRESHOLD", 1024)
    rng = np.random.default_rng(43)
    pts = np.unique(rng.integers(0, 64, (6000, 3)), axis=0).astype(float)
    c = Cloud.from_numpy(pts, pad_to=6144, device="cpu")
    ours = nops.estimate_normals_cloud(c)
    jc = _jax_cloud(pts, pad_to=6144)
    theirs = np.asarray(jnops.estimate_normals_cloud(jc))
    assert np.quantile(_dots(ours[: c.n], theirs[: c.n]), 0.001) > 0.999
    assert (6144, 30) in nops._LADDER_MEMO
    mn, mx = c._boundary_stats
    ref = Cloud.from_numpy(pts, pad_to=6144, device="cpu")
    mn_ref, mx_ref = boundary_stats(ref, backend="pruned")
    assert float(mn) == float(mn_ref) and float(mx) == float(mx_ref)
    assert [float(x) for x in jc._boundary_stats] == [float(mn), float(mx)]
    assert c.get_normals() is c.get_normals()  # cached on the cloud

    few = rng.uniform(0, 10, (20, 3))
    small = _sphere(900, 44)
    for p, pad in ((few, 2048), (small, None)):
        if pad is None:
            monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 65536)
            monkeypatch.setattr(jnops, "_PRUNE_THRESHOLD", 65536)
        c = Cloud.from_numpy(p, pad_to=pad, device="cpu")
        ours = nops.estimate_normals_cloud(c)[: c.n].numpy()
        theirs = np.asarray(jnops.estimate_normals_cloud(
            _jax_cloud(p, pad_to=pad)))[: c.n]
        np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, rtol=1e-5)
        assert np.quantile(_dots(ours, theirs), 0.001) > 0.999
        assert c._boundary_stats is None  # only the pruned pass caches them


def test_fused_without_normals_matches_jax(monkeypatch):
    """A pair without normals, D2 in both modes: every PSNR of the port
    within 1e-4 dB of the JAX package's, through the pruned estimation;
    the estimation's boundary stats replace the self-NN sweep."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops import normals as jnops
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused

    monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    monkeypatch.setattr(jnops, "_PRUNE_THRESHOLD", 1024)
    sweeps = []
    real = fused_mod.nn_pruned_sorted

    def spy(*args, **kw):
        sweeps.append(kw.get("exclude_self", False))
        return real(*args, **kw)

    monkeypatch.setattr(fused_mod, "nn_pruned_sorted", spy)
    o, r = _pair_arrays(6)
    for d2_mode in ("pc_error", "reference"):
        kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode=d2_mode)
        want = jfused(_jax_cloud(o[0], colors=o[1]),
                      _jax_cloud(r[0], colors=r[1]), backend="pruned", **kw)
        a = Cloud.from_numpy(o[0], colors=o[1], device="cpu")
        b = Cloud.from_numpy(r[0], colors=r[1], device="cpu")
        got = fused_evaluate(a, b, backend="pruned", **kw)
        assert set(got) == set(want)
        _assert_stats_close(got, want, [k for k in want if "psnr" in k])
        assert a._est_normals is not None and b._est_normals is not None
        # the self-NN sweep was skipped: its stats are the estimation's
        assert sweeps and not any(sweeps)
        assert float(got["min_sqrt"]) == float(a._boundary_stats[0])


def test_cli_without_normals_matches_jax(tmp_path, capsys):
    """The CLI on PLY files written without normals: --point-to-plane
    prints the table (normals estimated) with the JAX CLI's rows."""
    jax_on_cpu()
    from click.testing import CliRunner
    from open_pcc_metric_tpu.handler import cli as jax_cli

    o, r = _pair_arrays(7)
    op, rp = str(tmp_path / "o.ply"), str(tmp_path / "r.ply")
    write_ply(op, o[0], colors=o[1])
    write_ply(rp, r[0], colors=r[1])
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
        if "PSNR" in row[1]:
            got, want = _values(row[4]), _values(jrow[4])
            assert np.max(np.abs(got - want)) <= PSNR_TOL, (row, jrow)


@pytest.mark.cuda
def test_cuda_estimation_matches_cpu(monkeypatch):
    """The estimation path on the card launches K3 and K4 and gives the CPU
    plain versions' normals and boundary stats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the k-NN kernels have no CPU mode")
    monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    # 24 tiles, a multiple of 8: the counted schedule runs K3 (with 20, the
    # fixed one would run K3b and might launch no K3)
    pts = _sphere(6000, 45)
    want = nops.estimate_normals_cloud(Cloud.from_numpy(pts, device="cpu"))
    c = Cloud.from_numpy(pts, device="cuda")
    before = (refine_knn.launches, knn_moments.launches)
    got = nops.estimate_normals_cloud(c).cpu()
    assert refine_knn.launches > before[0] and knn_moments.launches > before[1]
    assert np.quantile(_dots(got[: c.n], want[: c.n]), 0.001) > 0.999
    assert float(c._boundary_stats[0]) == float(boundary_stats(
        Cloud.from_numpy(pts, device="cpu"), backend="pruned")[0])
