"""PyTorch port: ``datasets.py`` (a numpy copy) against the JAX package's.

The same seeds give bit-identical arrays and files, and the port's copy
keeps the properties ``tests/test_batch.py`` holds the JAX package's to:
integer, unique, unit-normal surfaces, and a D1 PSNR that falls as the QP
rises, here measured by the port's own evaluation.
"""
import numpy as np
import pytest

from open_pcc_metric_tpu_torch import datasets
from open_pcc_metric_tpu_torch.io import read_point_cloud

from test_torch_refine import jax_on_cpu


def _jax_datasets():
    jax_on_cpu()
    from open_pcc_metric_tpu import datasets as jdatasets

    return jdatasets


@pytest.mark.parametrize("n,grid,seed", [(5000, 256, 1), (3000, 128, 7)])
def test_voxel_surface_and_degradation_equal_jax(n, grid, seed):
    jd = _jax_datasets()
    got = datasets.voxel_surface(n, grid=grid, seed=seed)
    want = jd.voxel_surface(n, grid=grid, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pts, colors, _ = got
    for qp in (4, 22, 34):
        for g, w in zip(datasets.degrade_gpcc_like(pts, colors, qp, seed=seed),
                        jd.degrade_gpcc_like(pts, colors, qp, seed=seed)):
            np.testing.assert_array_equal(g, w)
    q, c = datasets.degrade_gpcc_like(pts, None, 10, seed=seed)
    assert c is None and q.shape[1] == 3


def test_write_qp_sweep_equals_jax(tmp_path):
    jd = _jax_datasets()
    ref, degraded = datasets.write_qp_sweep(str(tmp_path / "port"),
                                            n_points=1000, qps=(10, 22))
    jref, jdegraded = jd.write_qp_sweep(str(tmp_path / "jax"),
                                        n_points=1000, qps=(10, 22))
    assert [qp for qp, _ in degraded] == [qp for qp, _ in jdegraded]
    for p, jp in [(ref, jref)] + [(p, jp) for (_, p), (_, jp)
                                  in zip(degraded, jdegraded)]:
        with open(p, "rb") as f, open(jp, "rb") as g:
            assert f.read() == g.read(), p
    raw = read_point_cloud(ref)
    assert raw.normals is not None and raw.colors is not None
    assert len(degraded) == 2
    for _, p in degraded:
        deg = read_point_cloud(p)
        assert deg.n > 0 and deg.normals is None and deg.colors is not None


def test_voxel_surface_properties():
    pts, colors, normals = datasets.voxel_surface(5000, grid=256, seed=1)
    assert pts.shape[0] <= 5000
    assert np.array_equal(pts, np.round(pts))  # integer lattice
    assert np.unique(pts, axis=0).shape[0] == pts.shape[0]
    assert colors.min() >= 0 and colors.max() <= 1
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0,
                               rtol=1e-9)


def test_degradation_monotone_d1():
    """The port's D1 PSNR of each degraded cloud falls with the QP, and
    equals the float64 oracle's within 1e-4 dB."""
    jax_on_cpu()
    import oracle
    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    pts, colors, _ = datasets.voxel_surface(3000, grid=256, seed=2)
    a = Cloud.from_numpy(pts, device="cpu")
    psnrs = []
    for qp in (4, 16, 28):
        q, _ = datasets.degrade_gpcc_like(pts, colors, qp, seed=2)
        got = fused_evaluate(a, Cloud.from_numpy(q, device="cpu"))
        want = oracle.full_metrics(pts, q)
        assert abs(got["geo_psnr_sym"] - want["geo_psnr_sym"]) <= 1e-4, qp
        psnrs.append(got["geo_psnr_sym"])
    assert psnrs[0] > psnrs[1] > psnrs[2]
