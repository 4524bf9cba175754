"""PyTorch port: the thin host->device upload (``Cloud.from_numpy(thin=)``)
against the JAX package's.

Integer voxel points ride int16 and 8-bit colours uint8, widened on the
device; everything else falls back to the wide upload, per array. A thin
cloud holds the wide cloud's bits, and both hold the JAX package's. On the
CPU ``thin="auto"`` is wide, so these tests pass ``thin=True``; the test
marked ``cuda`` checks the card's default (thin) against the wide upload
there.
"""
import concurrent.futures as cf

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.batch import _CloudCache
from open_pcc_metric_tpu_torch.cloud import (PAD_SENTINEL, Cloud,
                                             _as_int16_points,
                                             _as_uint8_colors,
                                             _hydrate_colors_u8)
from open_pcc_metric_tpu_torch.io import write_ply

from test_torch_fused import _assert_stats_close
from test_torch_refine import jax_on_cpu


def _mk(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 1024, size=(n, 3)).astype(np.float64)
    col = rng.integers(0, 256, size=(n, 3)).astype(np.float64) / 255.0
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, col, nrm


def _jax_cloud(*arrays, thin):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    return JCloud.from_numpy(*arrays, dtype=jnp.float32, thin=thin)


def _same(cloud, jcloud):
    for name in ("points", "colors", "normals"):
        got, want = getattr(cloud, name), getattr(jcloud, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
    assert cloud.n == jcloud.n


@pytest.mark.parametrize("kind", ["integer voxel", "float points, non-u8"])
def test_thin_equals_wide_and_jax(kind):
    """Thin and wide hold the same bits, and JAX's (thin and wide); float
    points and colours that are not u/255 fall back to the wide upload."""
    pts, col, nrm = _mk()
    if kind != "integer voxel":
        pts = pts + 0.25  # not integer -> no int16 path
        col = col * 0.999  # not u/255 -> no uint8 path
        assert _as_int16_points(pts) is None and _as_uint8_colors(col) is None
    a = Cloud.from_numpy(pts, col, nrm, thin=True, device="cpu")
    b = Cloud.from_numpy(pts, col, nrm, thin=False, device="cpu")
    for thin in (True, False):
        _same(a, _jax_cloud(pts, col, nrm, thin=thin))
        _same(b, _jax_cloud(pts, col, nrm, thin=thin))
    # the padded tail carries the sentinel and zero colours in both paths
    assert torch.all(a.points[a.n:] == PAD_SENTINEL)
    assert torch.all(a.colors[a.n:] == 0)


def test_thin_options():
    """thin is "auto" or a bool (anything else raises TypeError, so a
    device in its positional place is caught); thin applies to float32
    only; a cloud without colours takes the thin points alone."""
    pts, col, nrm = _mk(300, seed=1)
    for bad in ("cpu", torch.device("cpu"), 1, None):
        with pytest.raises(TypeError):
            Cloud.from_numpy(pts, col, nrm, torch.float32, 512, bad)
    auto = Cloud.from_numpy(pts, col, nrm, torch.float32, 512, "auto",
                            device="cpu")
    thin = Cloud.from_numpy(pts, None, None, torch.float32, 512, True,
                            device="cpu")
    assert torch.equal(auto.points, thin.points) and thin.colors is None
    f64 = Cloud.from_numpy(pts, col, nrm, torch.float64, thin=True,
                           device="cpu")
    assert f64.points.dtype == f64.colors.dtype == torch.float64
    np.testing.assert_array_equal(f64.colors[: f64.n].numpy(), col)


def test_thin_rejects_out_of_range_int16():
    jax_on_cpu()
    from open_pcc_metric_tpu.cloud import _as_int16_points as jas_int16

    for pts, ok in (([[0.0, 1.0, 40000.0]], False),
                    ([[0.0, 1.0, -40000.0]], False),
                    ([[0.0, 1.0, 32767.0]], False),
                    ([[0.0, -5.0, 32766.0]], True),
                    ([[0.0, -32766.0, 0.5]], False)):
        pts = np.array(pts)
        got, want = _as_int16_points(pts), jas_int16(pts)
        assert (got is not None) == ok == (want is not None), pts
        if ok:
            assert got.dtype == np.int16
            np.testing.assert_array_equal(got, want)


def test_u8_color_hydrate_exhaustive_bit_exact():
    """The device conversion equals float32(float64(u8) / 255) and JAX's
    ``_hydrate_colors_u8`` for all 256 values; an arithmetic form in torch
    (``c / 255``, rewritten as a reciprocal multiply) does not."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import _hydrate_colors_u8 as jhydrate

    u = np.arange(256, dtype=np.uint8)
    host = np.asarray(u.astype(np.float64) / 255.0, dtype=np.float32)
    dev = _hydrate_colors_u8(torch.from_numpy(u.reshape(-1, 1))).numpy()
    np.testing.assert_array_equal(dev.ravel(), host)
    want = np.asarray(jhydrate(jnp.asarray(u.reshape(-1, 1))))
    np.testing.assert_array_equal(dev, want)
    rec = _as_uint8_colors(u.astype(np.float64).reshape(-1, 1) / 255.0)
    np.testing.assert_array_equal(rec.ravel(), u)


def test_thin_full_evaluation_equality():
    """The full fused suite is identical through the thin and wide
    uploads, and agrees with JAX's (thin) at the port's tolerances."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    pts, col, nrm = _mk(1500, seed=3)
    rec = np.unique(np.round(pts / 3.0) * 3.0, axis=0)
    rng = np.random.default_rng(5)
    rcol = rng.integers(0, 256, size=rec.shape).astype(np.float64) / 255.0
    rnrm = rng.normal(size=rec.shape)
    rnrm /= np.linalg.norm(rnrm, axis=1, keepdims=True)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    outs = []
    for thin in (True, False):
        a = Cloud.from_numpy(pts, col, nrm, thin=thin, device="cpu")
        b = Cloud.from_numpy(rec, rcol, rnrm, thin=thin, device="cpu")
        outs.append(fused_evaluate(a, b, **kw))
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        assert np.array_equal(np.asarray(outs[0][k]),
                              np.asarray(outs[1][k])), k
    want = jfused(_jax_cloud(pts, col, nrm, thin=True),
                  _jax_cloud(rec, rcol, rnrm, thin=True), **kw)
    assert set(outs[0]) == set(want)
    _assert_stats_close(outs[0], want)


def test_cloud_cache_single_flight_and_retry(tmp_path, monkeypatch):
    pts, col, nrm = _mk(300, seed=9)
    p = tmp_path / "c.ply"
    write_ply(str(p), pts, colors=col, normals=nrm)
    cache = _CloudCache()
    calls = []
    orig = Cloud.from_numpy

    def counting(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(Cloud, "from_numpy", staticmethod(counting))
    with cf.ThreadPoolExecutor(4) as pool:
        clouds = list(pool.map(
            lambda _: cache.get(str(p), "float32", 512, "cpu"), range(4)))
    assert all(c is clouds[0] for c in clouds)  # one load, shared object
    assert len(calls) == 1 and clouds[0].padded_size == 512
    # the device is part of the key
    assert cache.get(str(p), "float32", 512, torch.device("cpu")) is clouds[0]
    assert cache.get(str(p), "float64", 512, "cpu") is not clouds[0]

    missing = str(tmp_path / "nope.ply")
    with pytest.raises(FileNotFoundError):
        cache.get(missing, "float32", 512, "cpu")
    # the failed entry is not cached: a retry loads the file
    write_ply(missing, pts)
    assert cache.get(missing, "float32", 512, "cpu").n == 300


@pytest.mark.cuda
def test_cuda_thin_upload_equals_wide():
    """On the card the default upload is thin, and holds the wide
    upload's bits (the widen steps run there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the widen steps run on the card")
    pts, col, nrm = _mk(5000, seed=2)
    pts[:7] += 0.5  # one float row: points fall back, colours stay thin
    for p in (pts, np.round(pts)):
        auto = Cloud.from_numpy(p, col, nrm, device="cuda")
        thin = Cloud.from_numpy(p, col, nrm, thin=True, device="cuda")
        wide = Cloud.from_numpy(p, col, nrm, thin=False, device="cuda")
        host = Cloud.from_numpy(p, col, nrm, thin=False, device="cpu")
        for name in ("points", "colors", "normals"):
            w = getattr(host, name)
            for c in (auto, thin, wide):
                assert torch.equal(getattr(c, name).cpu(), w), name
