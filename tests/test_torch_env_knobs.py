"""PyTorch port: the environment knobs the JAX package honours, read by
the port at each call, against the JAX package under the same
monkeypatched environment.

``PCC_PAD_POLICY`` (the padded size, so which search a cloud takes),
``PCC_GRID_BUILD`` (where the Morton grid is built; the grid is the same),
``PCC_NN_CAP`` / ``PCC_NN_FT`` (the fused ladder's base rung; the port's
``pair_stats`` and ``boundary_stats`` read them too), ``PCC_KNN_CAP`` /
``PCC_KNN_FT`` (the estimation ladder's), and ``PCC_NN_P1`` /
``PCC_KNN_P1`` (the counted schedule's probe width). JAX reads
``PCC_NN_P1`` when ``nn_pruned_sorted`` traces, so its cache is cleared
before and after, and spies show the probe width on both sides; it reads
the others at each call.
"""
import re

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud, pad_bucket
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import grid as grid_mod
from open_pcc_metric_tpu_torch.ops import knn_pruned as knn_mod
from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_mod
from open_pcc_metric_tpu_torch.ops import normals as nops
from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned_sorted
from open_pcc_metric_tpu_torch.ops.nn import resolve_backend
from open_pcc_metric_tpu_torch.ops.nn_pruned import nn_pruned_sorted

from test_torch_fixed_sched import _knn_cloud, _spy
from test_torch_fused import _assert_stats_close, _pair_arrays
from test_torch_knn_pruned import assert_matches, jax_knn_sorted
from test_torch_nn_pruned import _check, _grid, _jax_nn, _points
from test_torch_refine import jax_on_cpu

K = 30


def _jcloud(pts, **kw):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    return JCloud.from_numpy(pts, dtype=jnp.float32, thin=False, **kw)


@pytest.mark.parametrize("policy", ["bucket", "pow2"])
def test_pad_policy_env_matches_jax(policy, monkeypatch):
    """``pad_bucket(n, "auto")`` and ``Cloud.from_numpy`` follow
    PCC_PAD_POLICY as JAX's do: a 40000-point cloud pads to 40960 rows and
    takes the brute force, or to 65536 and takes the pruned search."""
    jax_on_cpu()
    from open_pcc_metric_tpu.cloud import pad_bucket as jpad

    monkeypatch.setenv("PCC_PAD_POLICY", policy)
    for n in (1, 256, 257, 3000, 40000, 65537, 1_000_000):
        assert pad_bucket(n, "auto") == jpad(n, "auto") == pad_bucket(n, policy)
    pts = np.random.default_rng(1).uniform(0.0, 100.0, (40000, 3))
    c = Cloud.from_numpy(pts, device="cpu")
    assert c.padded_size == _jcloud(pts).padded_size
    assert c.padded_size == {"bucket": 40960, "pow2": 65536}[policy]
    assert resolve_backend("auto", c.padded_size) == {
        "bucket": "brute", "pow2": "pruned"}[policy]
    monkeypatch.setenv("PCC_PAD_POLICY", "other")  # JAX: the bucket policy
    assert pad_bucket(40000, "auto") == jpad(40000, "auto") == 40960


@pytest.mark.parametrize("mode", ["host", "device"])
def test_grid_build_env_matches_jax(mode, monkeypatch):
    """``Cloud.get_grid()`` builds where PCC_GRID_BUILD says (a spy shows
    which builder ran), and the grid equals JAX's under the same setting.
    The other builder gives the same sorted points, permutation and chunk
    boxes, all the searches read (its float32 Morton codes round apart
    from the host's float64 ones)."""
    other = {"host": "device", "device": "host"}[mode]
    calls = {"host": _spy(monkeypatch, grid_mod, "build_grid_host"),
             "device": _spy(monkeypatch, grid_mod, "build_grid")}
    pts = np.random.default_rng(2).integers(0, 64, (3000, 3)).astype(float)
    monkeypatch.setenv("PCC_GRID_BUILD", mode)
    g = Cloud.from_numpy(pts, device="cpu").get_grid()
    want = _jcloud(pts).get_grid()
    assert len(calls[mode]) == 1 and not calls[other]
    for x, y in zip(g, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    monkeypatch.setenv("PCC_GRID_BUILD", other)
    g2 = Cloud.from_numpy(pts, device="cpu").get_grid()
    assert len(calls[other]) == 1
    for field in ("points", "perm", "bbox_lo", "bbox_hi"):
        assert torch.equal(getattr(g, field), getattr(g2, field))


def test_nn_base_rung_env_matches_jax(monkeypatch):
    """PCC_NN_CAP=12, PCC_NN_FT=8: ``fused_evaluate`` starts its ladder
    there and remembers the rung JAX's remembers, with the same table;
    ``pair_stats`` and ``boundary_stats`` start there too, and an explicit
    rung wins."""
    from open_pcc_metric_tpu.ops import fused as jfused_mod

    monkeypatch.setattr(fused_mod, "_LADDER_MEMO", {})
    monkeypatch.setattr(jfused_mod, "_LADDER_MEMO", {})
    monkeypatch.setenv("PCC_NN_CAP", "12")
    monkeypatch.setenv("PCC_NN_FT", "8")
    o, r = _pair_arrays(4)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error",
              backend="pruned")
    calls = _spy(monkeypatch, fused_mod, "nn_pruned_sorted")
    a, b = (Cloud.from_numpy(*x, pad_to=4096, device="cpu") for x in (o, r))
    got = fused_mod.fused_evaluate(a, b, **kw)
    assert (calls[0][1]["cap"], calls[0][1]["fallback_tiles"]) == (12, 8)
    want = jfused_mod.fused_evaluate(
        *(_jcloud(x[0], colors=x[1], normals=x[2], pad_to=4096)
          for x in (o, r)), **kw)
    _assert_stats_close(got, want)
    (rung, _), = fused_mod._LADDER_MEMO.values()
    (jrung, _), = jfused_mod._LADDER_MEMO.values()
    assert rung == jrung == (12, 8)
    del calls[:]
    fused_mod.pair_stats(a.points, b.points, a.n, b.n, backend="pruned")
    assert all(c[1]["cap"] == 12 and c[1]["fallback_tiles"] == 8
               for c in calls) and len(calls) == 3
    del calls[:]
    fused_mod.boundary_stats(Cloud.from_numpy(o[0], pad_to=4096,
                                              device="cpu"), backend="pruned")
    assert (calls[0][1]["cap"], calls[0][1]["fallback_tiles"]) == (12, 8)
    del calls[:]
    fused_mod.pair_stats(a.points, b.points, a.n, b.n, backend="pruned",
                         prune_cap=16, with_boundary=False)
    assert [(c[1]["cap"], c[1]["fallback_tiles"]) for c in calls] == [
        (16, 8), (16, 8)]


def test_knn_base_rung_env_matches_jax(monkeypatch):
    """PCC_KNN_CAP=12, PCC_KNN_FT=8: ``estimate_normals_cloud`` starts its
    ladder there, climbs as JAX's does and remembers the same rung, with the
    same normals."""
    from open_pcc_metric_tpu.ops import normals as jnops

    monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    monkeypatch.setattr(jnops, "_PRUNE_THRESHOLD", 1024)
    monkeypatch.setattr(nops, "_LADDER_MEMO", {})
    monkeypatch.setattr(jnops, "_LADDER_MEMO", {})
    monkeypatch.setenv("PCC_KNN_CAP", "12")
    monkeypatch.setenv("PCC_KNN_FT", "8")
    rng = np.random.default_rng(3)
    pts = np.unique(rng.integers(0, 48, (3900, 3)), axis=0).astype(float)
    calls = _spy(monkeypatch, nops, "estimation_core")
    c = Cloud.from_numpy(pts, pad_to=4096, device="cpu")
    ours = nops.estimate_normals_cloud(c)[: c.n].numpy()
    assert calls[0][0][3:5] == (12, 8)
    theirs = np.asarray(jnops.estimate_normals_cloud(
        _jcloud(pts, pad_to=4096)))[: c.n]
    dots = np.abs((ours * theirs).sum(1))
    assert np.quantile(dots, 0.001) > 0.999
    # (12, 8) overflows in both packages; both certify one rung up
    assert nops._LADDER_MEMO[(4096, K)][0] == jnops._LADDER_MEMO[(4096, K)][0]
    assert nops._LADDER_MEMO[(4096, K)][0] == (12, 16)


def test_nn_p1_env_matches_jax(monkeypatch):
    """PCC_NN_P1=3: the counted schedule probes 3 chunks in both packages
    (JAX reads it when it traces); results equal; an explicit p1 wins."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops import refine_pallas
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted as jnn

    a, ga = _grid(_points("int", 3500, 131, hi=64), pad_to=4096)
    b, gb = _grid(_points("int", 3000, 132, hi=64), pad_to=4096)
    kw = dict(cap=12, fallback_tiles=16)
    monkeypatch.setenv("PCC_NN_P1", "3")
    calls = _spy(monkeypatch, nn_mod, "refine_nn")
    got = nn_pruned_sorted(ga, gb, a.n, **kw)
    assert calls[0][0][3].shape[1] == 3
    first = len(calls)
    nn_pruned_sorted(ga, gb, a.n, p1=8, **kw)
    assert calls[first][0][3].shape[1] == 8
    jcalls = _spy(monkeypatch, refine_pallas, "refine_nn_pallas_t")
    jnn.clear_cache()
    try:
        want = _jax_nn(ga, gb, a.n, **kw)
    finally:
        jnn.clear_cache()
        monkeypatch.delenv("PCC_NN_P1")
    assert jcalls[0][0][3].shape[1] == 3
    _check("int", got, want, ga, gb, a.n, b.n, False)


def test_knn_p1_env_matches_jax(monkeypatch):
    """PCC_KNN_P1=3: the counted k-NN (k = 8) probes 3 chunks in both
    packages (8 query tiles against 12 search chunks, cap 12); results
    equal."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops import refine_pallas
    from open_pcc_metric_tpu.ops.knn_pruned import knn_pruned_sorted as jknn

    a, ga = _knn_cloud(2000, 133, 8)
    b, gb = _knn_cloud(3000, 134, 12)
    kw = dict(cap=12, fallback_tiles=8)
    monkeypatch.setenv("PCC_KNN_P1", "3")
    calls = _spy(monkeypatch, knn_mod, "refine_knn")
    got = knn_pruned_sorted(ga, gb, a.n, 8, **kw)
    assert calls[0][0][3].shape[1] == 3
    jcalls = _spy(monkeypatch, refine_pallas, "refine_knn_pallas_t")
    jknn.clear_cache()
    try:
        want = jax_knn_sorted(ga, gb, a.n, k=8, **kw)
    finally:
        jknn.clear_cache()
    assert jcalls[0][0][3].shape[1] == 3
    assert_matches(got, want, a.n, k=8)


# The 1-NN knobs: (variable, a value it is set to, the NnSchedule field it
# sets, that field's resolver before NnSchedule, an explicit argument).
NN_KNOBS = [
    ("PCC_NN_SCHED", "fixed", "sched", lambda: nn_mod.resolve_nn_sched(),
     "counted"),
    ("PCC_NN_P1", "3", "p1", lambda: nn_mod.resolve_p1(None, "PCC_NN_P1"),
     8),
    ("PCC_NN_PROLOGUE", "select", "prologue",
     lambda: nn_mod.resolve_prologue(None, "PCC_NN_PROLOGUE"), "xla"),
    ("PCC_REFINE_IMPL", "adaptive", "refine_impl",
     lambda: nn_mod.resolve_refine_impl(), "xla"),
    ("PCC_NN_EXPANDED", "1", "refine_impl",
     lambda: nn_mod.resolve_refine_impl(), "default"),
    ("PCC_PAYLOAD_KERNEL", "1", "payload", lambda: nn_mod.resolve_payload(),
     False),
    ("PCC_NN_CAP", "12", "cap", lambda: nn_mod.nn_base_rung()[0], 32),
    ("PCC_NN_FT", "8", "fallback", lambda: nn_mod.nn_base_rung()[1], 256),
]
NN_DEFAULT = nn_mod.NnSchedule(sched="counted", p1=8, prologue="xla",
                               refine_impl="default", payload=False, cap=32,
                               fallback=256)


@pytest.mark.parametrize("var,value,field,old,explicit", NN_KNOBS,
                         ids=[k[0] for k in NN_KNOBS])
def test_resolve_nn_schedule_reads_each_knob(var, value, field, old,
                                             explicit, monkeypatch):
    """``resolve_nn_schedule`` with one knob set alone: that field is what
    its own resolver reads, every other field its default; an explicit
    argument beats the environment (a JAX refine name mapped as
    ``resolve_refine_impl`` maps it)."""
    for knob in NN_KNOBS:
        monkeypatch.delenv(knob[0], raising=False)
    assert nn_mod.resolve_nn_schedule() == NN_DEFAULT
    monkeypatch.setenv(var, value)
    got = nn_mod.resolve_nn_schedule()
    assert getattr(got, field) == old() != getattr(NN_DEFAULT, field)
    assert got == NN_DEFAULT._replace(**{field: old()})
    assert nn_mod.resolve_nn_schedule(**{field: explicit}) == NN_DEFAULT


@pytest.mark.parametrize("field,old", [
    ("sched", nn_mod.resolve_nn_sched),
    ("prologue", lambda v: nn_mod.resolve_prologue(v, "PCC_NN_PROLOGUE")),
    ("refine_impl", nn_mod.resolve_refine_impl)])
def test_resolve_nn_schedule_raises_as_its_resolvers(field, old):
    """An unknown schedule, prologue or refine schedule raises the
    ValueError its own resolver raises."""
    with pytest.raises(ValueError) as want:
        old("bogus")
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        nn_mod.resolve_nn_schedule(**{field: "bogus"})
