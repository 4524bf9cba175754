"""PyTorch port: the library API called as the JAX package is called.

One walk over both packages (``test_api_walk``): every public function,
class, method and property defined in a module of ``open_pcc_metric_tpu``
(``pkgutil.walk_packages``; not the three Pallas modules, whose kernels
are ``csrc/``'s, nor the native ``libpccio`` shim) has its counterpart at
the same path in ``open_pcc_metric_tpu_torch``, unless ``NOT_PORTED``
says why not. Each counterpart

  * takes JAX's positional parameters, in JAX's order and under JAX's
    names (``RENAMED`` holds the one that differs, with its reason), and
    no more: the port's own parameters are keyword-only, so a positional
    call made the JAX package's way binds every argument to its JAX
    meaning (the TPU layout parameters are taken in their places and
    checked, ``open_pcc_metric_tpu_torch/_layout_args.py``);
  * takes every parameter JAX names, with JAX's default (a JAX dtype
    standing for the torch dtype of the same name), or with a default
    listed in ``KNOWN_DEFAULTS`` beside the test that shows the same
    result under JAX's value.

Besides: the port's ``ops``, ``utils`` and ``parallel`` export JAX's
names; ``Cloud.from_numpy`` binds JAX's positional order with ``device``
keyword-only; and ``minimal_obb_extent(device=True/False)`` has JAX's
meaning: True runs the projection sweep on the CUDA device (raising
without one), False keeps it in numpy. Every case here only imports and
inspects, or runs in numpy or eager PyTorch: no JAX program is compiled.
"""
import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_pcc_metric_tpu
from open_pcc_metric_tpu.cloud import Cloud as JCloud
from open_pcc_metric_tpu.ops.obb import minimal_obb_extent as jax_obb
from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.obb import minimal_obb_extent

JAX, PORT = "open_pcc_metric_tpu", "open_pcc_metric_tpu_torch"

# Modules the walk leaves out: the Pallas kernels (ported as csrc/'s CUDA
# sources, PERF.md's kernel table) and the native libpccio shim (the port
# has its own copy, tests/test_torch_native.py).
SKIPPED_MODULES = {"ops.nn_pallas", "ops.refine_pallas", "ops.select_pallas",
                   "native"}

# JAX names with no counterpart, each with its reason.
NOT_PORTED = {
    "utils.cache.enable_compile_cache":
        "configures JAX's persistent XLA compile cache; eager PyTorch has "
        "no such cache",
    "calculator.CalculateResult.as_df":
        "returns a pandas frame: the card's host has no pandas and the port "
        "imports none (test_torch_fused.py::"
        "test_port_imports_no_jax_pandas_click); rows() carries its four "
        "columns (test_torch_api_calls.py::test_rows_equal_jax_as_df)",
}

# JAX parameters the port takes in the same place under another name, each
# because its layout differs: the port's sorted payload is (Pb, PAYLOAD_F)
# rows, JAX's payT_sorted its transpose, which the port refuses
# (test_torch_api_calls.py::test_payload_jax_layout_raises); a keyword
# call by JAX's name raises TypeError.
RENAMED = {
    "ops.nn_pruned.nn_pruned_sorted_payload": {"payT_sorted": "pay_sorted"},
}

# Defaults that differ from JAX's: "module.function.parameter" -> (reason,
# the test that shows the same result under JAX's value).
KNOWN_DEFAULTS = {
    "ops.fused.pair_stats.prune_cap": (
        "None reads PCC_NN_CAP at the call (nn_base_rung), 32 when unset",
        "test_torch_api_calls.py::test_pair_stats_default_rung_is_jax"),
    "ops.fused.pair_stats.prune_fallback": (
        "None reads PCC_NN_FT at the call (nn_base_rung), 256 when unset",
        "test_torch_api_calls.py::test_pair_stats_default_rung_is_jax"),
    "utils.logging.get_logger.name": (
        "the port's logger keeps its own name, so a process running both "
        "packages keeps their logs apart",
        "test_torch_api_calls.py::test_logger_default_name_configures_alike"),
}


def _jax_modules():
    names = [JAX] + [m.name for m in pkgutil.walk_packages(
        open_pcc_metric_tpu.__path__, JAX + ".")]
    return [n for n in names if not any(
        n[len(JAX) + 1:] == s or n[len(JAX) + 1:].startswith(s + ".")
        for s in SKIPPED_MODULES)]


def _defined(module):
    """The public functions (jitted ones included) and classes that
    ``module`` defines."""
    for name, obj in vars(module).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                module.__name__:
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj) or hasattr(
                obj, "__wrapped__"):
            yield name, obj


def _members(cls):
    """The public methods and properties a class defines itself."""
    for name, obj in vars(cls).items():
        if name.startswith("_"):
            continue
        if isinstance(obj, (staticmethod, classmethod)):
            obj = obj.__func__
        if isinstance(obj, property) or inspect.isfunction(obj):
            yield name, obj


def _walk():
    """(qualified name relative to the package, JAX object, the port's
    module path, the attribute path under it)."""
    out = []
    for mod in _jax_modules():
        rel = mod[len(JAX) + 1:]
        for name, obj in _defined(importlib.import_module(mod)):
            qual = f"{rel}.{name}" if rel else name
            out.append((qual, obj, rel, (name,)))
            if inspect.isclass(obj):
                out += [(f"{qual}.{m}", o, rel, (name, m))
                        for m, o in _members(obj)]
    return out


WALK = _walk()
_MISSING = object()


def _port_object(rel, path):
    module = importlib.import_module(f"{PORT}.{rel}" if rel else PORT)
    obj = getattr(module, path[0], _MISSING)
    if len(path) == 2 and obj is not _MISSING:
        obj = inspect.getattr_static(obj, path[1], _MISSING)
        if isinstance(obj, (staticmethod, classmethod)):
            obj = obj.__func__
    return obj


def _as_port_default(value):
    """JAX's default as the port spells it: a JAX dtype (a scalar type
    with a numpy ``dtype``) is the torch dtype of the same name."""
    if isinstance(value, type) and isinstance(getattr(value, "dtype", None),
                                              np.dtype):
        return getattr(torch, value.dtype.name)
    return value


def _same_default(want, got):
    want = _as_port_default(want)
    return type(want) is type(got) and want == got


_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _check_signature(qual, jax_obj, port_obj):
    """The walk's rule for one callable (module docstring)."""
    want, got = inspect.signature(jax_obj), inspect.signature(port_obj)
    renamed = RENAMED.get(qual, {})
    jparams = [p.replace(name=renamed.get(p.name, p.name))
               for p in want.parameters.values()]
    pparams = dict(got.parameters)
    assert [p.name for p in pparams.values() if p.kind in _POSITIONAL] == \
        [p.name for p in jparams if p.kind in _POSITIONAL], qual
    jnames = {p.name for p in jparams}
    for p in pparams.values():
        assert p.name in jnames or p.kind in (
            p.KEYWORD_ONLY, p.VAR_KEYWORD), (qual, p.name)
    for p in jparams:
        if p.kind in _VAR:
            assert any(q.kind == p.kind for q in pparams.values()), (
                qual, p.name)
            continue
        q = pparams.get(p.name)
        assert q is not None, (qual, p.name)
        if p.default is p.empty:
            continue
        key = f"{qual}.{p.name}"
        if key in KNOWN_DEFAULTS:
            assert not _same_default(p.default, q.default), (
                f"{key}: the defaults agree now; drop it from KNOWN_DEFAULTS")
        else:
            assert _same_default(p.default, q.default), (
                key, p.default, q.default)


@pytest.mark.parametrize("qual,jax_obj,rel,path", WALK,
                         ids=[w[0] for w in WALK])
def test_api_walk(qual, jax_obj, rel, path):
    port_obj = _port_object(rel, path)
    if qual in NOT_PORTED:
        assert port_obj is _MISSING, f"{qual} is ported: drop it from " \
            "NOT_PORTED"
        return
    assert port_obj is not _MISSING, f"{qual} has no counterpart in the port"
    if isinstance(jax_obj, property):
        return
    assert inspect.isclass(port_obj) == inspect.isclass(jax_obj), qual
    _check_signature(qual, jax_obj, port_obj)


def test_walk_lists_name_walked_entries():
    """Every entry of NOT_PORTED, RENAMED and KNOWN_DEFAULTS names a JAX
    object the walk reaches (and a parameter of it), and every test a
    KNOWN_DEFAULTS entry names exists; the walk reaches every package."""
    walked = {w[0]: w[1] for w in WALK}
    assert set(NOT_PORTED) <= set(walked)
    for qual, names in RENAMED.items():
        assert set(names) <= set(inspect.signature(walked[qual]).parameters)
    for key, (_, test) in KNOWN_DEFAULTS.items():
        qual, param = key.rsplit(".", 1)
        assert param in inspect.signature(walked[qual]).parameters, key
        path, name = test.split("::")
        module = importlib.import_module(path.removesuffix(".py"))
        assert callable(getattr(module, name)), test
    for package in ("ops", "parallel", "utils", "io"):
        assert any(q.startswith(package + ".") for q in walked), package
    assert not any(q.split(".")[-2] in ("nn_pallas", "refine_pallas",
                                        "select_pallas") for q in walked)


def _exports(package, sub):
    return importlib.import_module(f"{package}.{sub}").__all__


# The port's own additions: utils keeps its rung-ladder memo helpers.
PORT_ONLY = {"ops": [], "utils": ["ladder_lookup", "ladder_store",
                                  "next_rung"]}


@pytest.mark.parametrize("sub", ["ops", "utils"])
def test_all_lists_match_jax(sub):
    not_ported = {q.rsplit(".", 1)[-1] for q in NOT_PORTED}
    want = [n for n in _exports(JAX, sub)
            if n not in not_ported] + PORT_ONLY[sub]
    assert sorted(_exports(PORT, sub)) == sorted(want)


@pytest.mark.parametrize("sub", ["ops", "utils"])
def test_every_export_imports(sub):
    """Each exported name resolves, and the JAX names resolve to callables
    (or constants) of the same kind; ``ops.nn_pruned`` stays a module."""
    port = importlib.import_module(f"{PORT}.{sub}")
    ref = importlib.import_module(f"{JAX}.{sub}")
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
            if p.kind in _POSITIONAL]


def _keyword_only(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == p.KEYWORD_ONLY]


def test_parallel_all_matches_jax():
    """``parallel`` exports the JAX package's seven ring names, plus its
    ``multihost`` module (a submodule in the JAX package)."""
    want = _exports(JAX, "parallel") + ["multihost"]
    assert sorted(_exports(PORT, "parallel")) == sorted(want)


# The port's added parameters: a mesh's slots may name torch devices.
PARALLEL_PORT_ONLY = {"make_mesh": ["devices"]}


@pytest.mark.parametrize("name", importlib.import_module(
    "open_pcc_metric_tpu.parallel").__all__)
def test_parallel_positional_names_match_jax(name):
    """Each exported ring function keeps the walk's rule, ``axis`` in
    JAX's place (checked, unused: a ring's slots are a list here), and
    takes the port's own parameters by keyword only."""
    port = getattr(importlib.import_module(f"{PORT}.parallel"), name)
    ref = getattr(importlib.import_module(f"{JAX}.parallel"), name)
    _check_signature(f"parallel.sharded.{name}", ref, port)
    assert _keyword_only(port) == PARALLEL_PORT_ONLY.get(name, [])


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
    keep the walk's rule, the TPU layout parameters (``qt8``, ``qt8_a``,
    ``qt8_b``, ``interpret``) in JAX's places, and take exactly these
    port parameters by keyword only."""
    port = getattr(importlib.import_module(f"{PORT}.{module}"), name)
    ref = getattr(importlib.import_module(f"{JAX}.{module}"), name)
    _check_signature(f"{module}.{name}", ref, port)
    assert _keyword_only(port) == port_only


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
