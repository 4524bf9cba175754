"""PyTorch port: the copied ``native`` host loops against the JAX package's.

Mirrors ``tests/test_native.py``: the C++ library builds, parses floats
correctly rounded, sorts stably and gathers rows; each result equals the
JAX package's copy and numpy's. Without ``g++`` the loaders use their
numpy fallbacks and these tests skip, as the JAX package's do.
"""
import numpy as np
import pytest

from open_pcc_metric_tpu_torch import native

from test_torch_refine import jax_on_cpu


@pytest.fixture(scope="module")
def jnative():
    jax_on_cpu()
    from open_pcc_metric_tpu import native as jnative

    if native.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("g++ unavailable; numpy fallbacks cover this machine")
    return jnative


@pytest.mark.parametrize("data,count,want", [
    (b"1.5 -2e3\n 0.25\t7\n-0.0 1e-8", 6,
     [1.5, -2000.0, 0.25, 7.0, -0.0, 1e-8]),
    (b"1 2 3", 5, None),  # short input
], ids=["mixed", "short"])
def test_parse_floats(jnative, data, count, want):
    got = native.parse_floats(data, count)
    ref = jnative.parse_floats(data, count)
    if want is None:
        assert got is None and ref is None
    else:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, want)
        assert np.signbit(got[4])  # -0.0 keeps its sign


def test_parse_floats_correctly_rounded(jnative):
    vals = np.random.default_rng(0).uniform(-1e6, 1e6, 1000)
    text = "\n".join(repr(float(v)) for v in vals).encode()
    out = native.parse_floats(text, 1000)
    np.testing.assert_array_equal(out, vals)  # strtod is correctly rounded
    np.testing.assert_array_equal(out, jnative.parse_floats(text, 1000))


def test_radix_argsort_matches_numpy_stable(jnative):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**30, 100_000).astype(np.uint32)
    keys[::7] = keys[0]  # many ties: the order among them is the input's
    perm = native.radix_argsort_u32(keys)
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(perm, jnative.radix_argsort_u32(keys))


def test_gather_rows(jnative):
    rng = np.random.default_rng(2)
    src = rng.normal(size=(1000, 3))
    perm = rng.permutation(1000).astype(np.int32)
    out = native.gather_rows(src, perm)
    np.testing.assert_array_equal(out, src[perm])
    np.testing.assert_array_equal(out, jnative.gather_rows(src, perm))


def test_ascii_ply_roundtrip_uses_native(tmp_path, jnative):
    from open_pcc_metric_tpu import read_point_cloud as jread
    from open_pcc_metric_tpu_torch import read_point_cloud, write_ply

    rng = np.random.default_rng(3)
    pts = rng.uniform(-100, 100, (5000, 3))
    colors = rng.integers(0, 256, (5000, 3)) / 255.0
    p = tmp_path / "a.ply"
    write_ply(p, pts, colors=colors, binary=False)
    raw, ref = read_point_cloud(p), jread(p)
    np.testing.assert_allclose(raw.points, pts, rtol=1e-9)
    np.testing.assert_allclose(raw.colors, colors, atol=1e-9)
    np.testing.assert_array_equal(raw.points, ref.points)
    np.testing.assert_array_equal(raw.colors, ref.colors)
