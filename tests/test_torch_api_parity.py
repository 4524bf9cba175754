"""PyTorch port: the library API called as the JAX package is called.

The port's ``ops`` and ``utils`` export the JAX package's names (less
``enable_compile_cache``, which has no counterpart in eager PyTorch), and
``parallel`` its seven ring names plus ``multihost``, each ring function
with JAX's positional parameters less ``axis``;
``Cloud.from_numpy`` takes JAX's positional order (points, colors,
normals, dtype, pad_to, thin) with ``device`` keyword-only; and
``minimal_obb_extent(device=True/False)`` has JAX's meaning: True runs the
projection sweep on the CUDA device (raising without one), False keeps it
in numpy. Every case here runs on the CPU in numpy or eager PyTorch: no
JAX program is compiled.
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu.cloud import Cloud as JCloud
from open_pcc_metric_tpu.ops.obb import minimal_obb_extent as jax_obb
from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.obb import minimal_obb_extent

# JAX's names with no torch counterpart: its persistent XLA compile cache.
NOT_PORTED = {"enable_compile_cache"}


def _exports(package, sub):
    return importlib.import_module(f"{package}.{sub}").__all__


# The port's own additions: utils keeps its rung-ladder memo helpers.
PORT_ONLY = {"ops": [], "utils": ["ladder_lookup", "ladder_store",
                                  "next_rung"]}


@pytest.mark.parametrize("sub", ["ops", "utils"])
def test_all_lists_match_jax(sub):
    want = [n for n in _exports("open_pcc_metric_tpu", sub)
            if n not in NOT_PORTED] + PORT_ONLY[sub]
    assert sorted(_exports("open_pcc_metric_tpu_torch", sub)) == sorted(want)


@pytest.mark.parametrize("sub", ["ops", "utils"])
def test_every_export_imports(sub):
    """Each exported name resolves, and the JAX names resolve to callables
    (or constants) of the same kind; ``ops.nn_pruned`` stays a module."""
    port = importlib.import_module(f"open_pcc_metric_tpu_torch.{sub}")
    ref = importlib.import_module(f"open_pcc_metric_tpu.{sub}")
    for name in port.__all__:
        got = getattr(port, name)
        if hasattr(ref, name):
            assert callable(got) == callable(getattr(ref, name)), name
    if sub == "ops":
        from open_pcc_metric_tpu_torch.ops import (PRUNE_THRESHOLD,
                                                   fused_evaluate)

        assert callable(fused_evaluate) and PRUNE_THRESHOLD == 65536
        assert type(port.nn_pruned).__name__ == "module"
    else:
        from open_pcc_metric_tpu_torch.utils import get_logger

        assert get_logger() is get_logger()


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_parallel_all_matches_jax():
    """``parallel`` exports the JAX package's seven ring names, plus its
    ``multihost`` module (a submodule in the JAX package)."""
    want = _exports("open_pcc_metric_tpu", "parallel") + ["multihost"]
    assert sorted(_exports("open_pcc_metric_tpu_torch", "parallel")) == \
        sorted(want)


# The port's added parameters: a mesh's slots may name torch devices.
PARALLEL_PORT_ONLY = {"make_mesh": ["devices"]}


@pytest.mark.parametrize(
    "name", importlib.import_module("open_pcc_metric_tpu.parallel").__all__)
def test_parallel_positional_names_match_jax(name):
    """Each exported ring function takes JAX's positional parameters in
    JAX's order, less ``axis`` (the port's ring functions take one tensor
    a slot, so the mesh axis is implicit)."""
    port = importlib.import_module("open_pcc_metric_tpu_torch.parallel")
    ref = importlib.import_module("open_pcc_metric_tpu.parallel")
    want = [n for n in _positional(getattr(ref, name)) if n != "axis"]
    assert _positional(getattr(port, name)) == want + PARALLEL_PORT_ONLY.get(
        name, [])


# The TPU layout parameters of the JAX package's searches: its transposed
# (8, P) query packs, interpret-mode switch and ring chunking. The port's
# kernels read the sorted points as they are, so it takes none of them.
TPU_LAYOUT = {"qt8", "qt8_a", "qt8_b", "interpret", "chunk_a", "chunk_b"}

# (module, name, the port's keyword-only additions after JAX's parameters)
SEARCH_FUNCTIONS = [
    ("ops.knn_pruned", "knn_pruned_sorted", ["p1", "prologue", "sched"]),
    ("ops.knn_pruned", "knn_flags_from_env", []),
    ("ops.nn_pruned", "nn_pruned_sorted", ["p1", "prologue", "sched"]),
    ("ops.nn_pruned", "nn_pruned_bucketed_sorted", []),
    ("ops.fused", "pair_stats", ["prologue", "refine_impl", "payload",
                                 "sched"]),
    ("ops.fused", "cold_pair_program", ["prologue", "refine_impl",
                                        "payload", "sched"]),
    ("ops.normals", "estimation_core", []),
]


@pytest.mark.parametrize("module,name,port_only", SEARCH_FUNCTIONS,
                         ids=[n for _, n, _ in SEARCH_FUNCTIONS])
def test_search_positional_names_match_jax(module, name, port_only):
    """The searches, the fused evaluation's programs and the estimation
    take JAX's positional parameters in JAX's order, less the TPU layout
    ones; the port's own parameters are keyword-only, after them, so a
    JAX-style positional call binds every argument to its JAX meaning."""
    port = getattr(importlib.import_module(
        f"open_pcc_metric_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"open_pcc_metric_tpu.{module}"),
                  name)
    want = [n for n in _positional(ref) if n not in TPU_LAYOUT]
    assert _positional(port) == want
    kw_only = [p.name for p in inspect.signature(port).parameters.values()
               if p.kind == p.KEYWORD_ONLY]
    assert kw_only == port_only


def _arrays(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (n, 3)).astype(np.float64),
            rng.uniform(0, 1, (n, 3)))


def test_from_numpy_positional_equals_keyword():
    pts, col = _arrays()
    pos = Cloud.from_numpy(pts, col, None, torch.float32, 4096, device="cpu")
    kw = Cloud.from_numpy(pts, colors=col, dtype=torch.float32, pad_to=4096,
                          device="cpu")
    assert pos.n == kw.n == len(pts) and pos.padded_size == 4096
    assert torch.equal(pos.points, kw.points)
    assert torch.equal(pos.colors, kw.colors) and pos.normals is None


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_from_numpy_positional_device_raises(device):
    pts, _ = _arrays(100)
    with pytest.raises(TypeError):
        Cloud.from_numpy(pts, None, None, device)
    with pytest.raises(TypeError):
        Cloud.from_numpy(pts, None, None, torch.float32, 256, device)


def test_from_numpy_positional_names_match_jax():
    """The port's positional parameters are JAX's, in JAX's order."""
    assert _positional(Cloud.from_numpy) == _positional(JCloud.from_numpy) == [
        "points", "colors", "normals", "dtype", "pad_to", "thin"]
    kw_only = [p.name for p in inspect.signature(
        Cloud.from_numpy).parameters.values() if p.kind == p.KEYWORD_ONLY]
    assert kw_only == ["device", "pad_policy"]


def test_from_numpy_positional_matches_jax():
    """JAX's positional call and the port's, with the same (dtype,
    pad_to), give the same padded rows."""
    pts, col = _arrays()
    want = JCloud.from_numpy(pts, col, None, jnp.float32, 2048)
    got = Cloud.from_numpy(pts, col, None, torch.float32, 2048, device="cpu")
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.colors.numpy(), np.asarray(want.colors))
    assert got.n == want.n and got.padded_size == 2048


def _hull_cloud():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(3000, 3)) * np.array([40.0, 15.0, 6.0])
    return np.round(pts @ np.linalg.qr(rng.normal(size=(3, 3)))[0], 3)


def test_obb_false_equals_jax_numpy_sweep():
    pts = _hull_cloud()
    got = minimal_obb_extent(pts, device=False)
    want = jax_obb(pts, device=False)
    np.testing.assert_array_equal(got, want)


def test_obb_named_device_agrees():
    """A named device runs the sweep in float64 torch there: the winning
    frame's extent is recomputed on the host, so it agrees with numpy's
    to rounding (1e-12 relative)."""
    pts = _hull_cloud()
    got = minimal_obb_extent(pts, device="cpu")
    np.testing.assert_allclose(got, minimal_obb_extent(pts, device=False),
                               rtol=1e-12, atol=0)


def test_obb_true_needs_cuda():
    """``device=True``, the default, is the CUDA device: without one it
    raises rather than sweep on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=True runs there")
    pts = _hull_cloud()
    with pytest.raises(RuntimeError, match="CUDA"):
        minimal_obb_extent(pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        minimal_obb_extent(pts, device=True)
