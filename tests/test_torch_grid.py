"""PyTorch port: padded clouds and the Morton chunk grid against the JAX package.

The same numpy inputs (from a seed) go through both packages. Cloud buffers,
grid permutations, sorted points, Morton codes and chunk bboxes must be
bit-identical — padding rows included — on integer and on float clouds.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud, pad_bucket, round_up
from open_pcc_metric_tpu_torch.ops.grid import (
    bbox_lower_bounds, build_grid, build_grid_host, morton_codes)

from test_torch_refine import jax_on_cpu


def _points(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 512, (n, 3)).astype(np.float64)
    return rng.uniform(-50.0, 150.0, (n, 3))


def _jax_cloud(pts, **kw):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    return JCloud.from_numpy(pts, dtype=jnp.float32, thin=False, **kw)


def _assert_grids_equal(jg, tg):
    for field in ("points", "perm", "codes", "bbox_lo", "bbox_hi",
                  "chunk_codes"):
        want = np.asarray(getattr(jg, field))
        got = getattr(tg, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("policy", ["bucket", "pow2"])
def test_pad_bucket_matches_jax(policy):
    jax_on_cpu()
    from open_pcc_metric_tpu import cloud as jcloud

    for n in [1, 255, 256, 257, 1000, 4097, 65535, 65536, 800_001, 2_000_000]:
        assert pad_bucket(n, policy) == jcloud.pad_bucket(n, policy), n
        assert round_up(n, 256) == jcloud.round_up(n, 256)


def test_cloud_buffers_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 100, (700, 3))
    col = rng.uniform(0, 1, (700, 3))
    nrm = rng.normal(size=(700, 3))
    j = _jax_cloud(pts, colors=col, normals=nrm)
    t = Cloud.from_numpy(pts, colors=col, normals=nrm, device="cpu")
    assert t.n == j.n and t.padded_size == j.padded_size
    for field in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(j, field)))


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("n", [300, 5000])
def test_build_grid_matches_jax(kind, n):
    """Device-style build: stable sort on the int32 codes == JAX's 2-key
    (code, row) sort; the f32 quantisation is the same op for op."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops import grid as jgrid

    pts = _points(kind, n, seed=n)
    j = _jax_cloud(pts)
    t = Cloud.from_numpy(pts, device="cpu")

    jg = jgrid.build_grid(j.points, jnp.asarray(j.n))
    tg = build_grid(t.points, t.n)
    _assert_grids_equal(jg, tg)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_build_grid_host_matches_jax(kind):
    jax_on_cpu()
    pts = _points(kind, 3000, seed=5)
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops import grid as jgrid

    jg = jgrid.build_grid_host(pts, 4096, dtype=jnp.float32)
    tg = build_grid_host(pts, 4096, dtype=torch.float32)
    _assert_grids_equal(jg, tg)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_sentinels_sort_last(kind):
    """Sorted rows >= n are exactly the sentinel originals (mirrors
    tests/test_pruned.py::test_morton_sentinels_sort_last) and carry the
    lattice-corner code: the float clamp before the int cast at work."""
    pts = _points(kind, 5000, seed=9)
    t = Cloud.from_numpy(pts, device="cpu")
    g = build_grid(t.points, t.n)
    assert set(g.perm[t.n:].tolist()) == set(range(t.n, t.padded_size))
    assert np.all(g.codes[t.n:].numpy() == 0x3FFFFFFF)
    codes = morton_codes(t.points, t.n).numpy()
    assert codes[: t.n].max() <= 0x3FFFFFFF and codes.min() >= 0


def test_bbox_lower_bounds_matches_jax():
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops import grid as jgrid

    pts = _points("int", 5000, seed=2)
    t = Cloud.from_numpy(pts, device="cpu")
    g = build_grid(t.points, t.n)
    want = jgrid.bbox_lower_bounds(*(jnp.asarray(x.numpy()) for x in (
        g.bbox_lo, g.bbox_hi, g.bbox_lo, g.bbox_hi)))
    got = bbox_lower_bounds(g.bbox_lo, g.bbox_hi, g.bbox_lo, g.bbox_hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.all(got.diagonal() == 0)
