"""Test config: force the CPU backend with 8 virtual devices (SURVEY §4d).

Tests exercise multi-chip sharding on a virtual 8-device CPU mesh; the real
TPU path is covered by bench.py and __graft_entry__.py on hardware. The env
may pre-register a TPU PJRT plugin at interpreter startup, so the platform is
overridden through jax.config (effective until backends initialise) rather
than via JAX_PLATFORMS alone.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# ---------------------------------------------------------------- quick gate
# `pytest -m quick` (VERDICT r3 item 7): a curated <2-minute-on-1-core slice
# covering the correctness core (goldens, reference-unit parity, engine
# equality, D1/D2/colour parity vs the f64 oracle, loaders) plus sharded
# multi-chip equality. The driver host's core count varies per session; the
# full 200+-test suite can exceed a tool window on a 1-core day.

_QUICK_MODULES = {"test_goldens", "test_reference_units", "test_loaders",
                  "test_thin_transfer"}
# (module, test-id prefix after '::') — parametrised ids included explicitly.
_QUICK_TESTS = {
    ("test_fuzz", "test_tiny_clouds_full_pipeline"),
    ("test_fuzz", "test_engines_agree_on_float32_voxel"),
    ("test_fuzz", "test_backends_agree_random_shapes[0]"),
    ("test_metrics", "test_d1_parity_voxel[float64]"),
    ("test_metrics", "test_d2_parity_pinned_normals[reference]"),
    ("test_metrics", "test_d2_parity_pinned_normals[pc_error]"),
    ("test_metrics", "test_color_parity[ycc]"),
    ("test_metrics", "test_fused_engine_equals_dag_engine[kw0]"),
    ("test_sharded", "test_sharded_full_step_matches_fused[2-ycc-False]"),
    ("test_sharded", "test_sharded_full_step_matches_fused[1-None-True]"),
    ("test_sharded", "test_sharded_pruned_step_matches_fused[ycc-True-pc_error]"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.nodeid.rsplit("/", 1)[-1].split("::")[0].removesuffix(".py")
        name = item.nodeid.split("::", 1)[-1]
        if mod in _QUICK_MODULES or (mod, name) in _QUICK_TESTS:
            item.add_marker(pytest.mark.quick)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels have no CPU mode); "
        "skips without one",
    )
