"""PyTorch port: the fixed-cap schedules of the pruned 1-NN and k-NN
(``sched="fixed"``, ``PCC_NN_SCHED`` / ``PCC_KNN_SCHED``, and any cap <= 8)
against the JAX package's.

Stage 1 of the port's fixed schedule is K2c's candidates and one K1b (K3b)
launch over every tile. The JAX side runs ``nn_pruned_sorted`` /
``knn_pruned_sorted`` with ``refine_impl="pallas_interpret"``; on 12 query
tiles (not a whole number of 8-tile groups) its stage 1 runs the straight
kernels ``refine_nn_pallas`` (through ``_nn_group``) and
``refine_knn_pallas``. JAX reads ``PCC_NN_SCHED`` when it traces, so its
caches are cleared before and after, its transposed refine runs unjitted
inside the trace, and spies prove which kernels ran on both sides. Valid
rows must agree bit for bit (integer clouds; float clouds by the rule of
test_torch_refine.py), with the same ``overflow``, and equal the port's
counted schedule.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import knn_pruned as knn_mod
from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_mod
from open_pcc_metric_tpu_torch.ops import normals as nops
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned_sorted
from open_pcc_metric_tpu_torch.ops.nn_pruned import nn_pruned_sorted
from open_pcc_metric_tpu_torch.utils.cache import next_rung

from test_torch_fused import _pair_arrays
from test_torch_knn_pruned import assert_matches, jax_knn_sorted
from test_torch_nn_pruned import _check, _grid, _jax_nn, _points
from test_torch_refine import jax_on_cpu

K = 30


def _spy(monkeypatch, module, name):
    """Record each call of ``module.name`` as (args, kwargs), passing it
    on."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _port_spies(monkeypatch):
    return {name: _spy(monkeypatch, mod, name) for mod, name in (
        (nn_mod, "select_candidates"), (nn_mod, "refine_nn_straight"),
        (nn_mod, "refine_nn"), (knn_mod, "refine_knn_straight"),
        (knn_mod, "refine_knn"))}


def _jax_traced(monkeypatch, env, jfn, inner, straight, call):
    """``call()`` with ``env`` set and the JAX function ``jfn``'s cache
    cleared before and after; the jitted transposed refine ``inner`` of
    refine_pallas runs unjitted inside the trace, so the spy on its
    straight fallback ``straight`` sees every call. Returns (result,
    straight calls)."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops import refine_pallas

    fn = getattr(refine_pallas, inner)
    monkeypatch.setattr(refine_pallas, inner, getattr(fn, "__wrapped__", fn))
    calls = _spy(monkeypatch, refine_pallas, straight)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    jfn.clear_cache()
    try:
        out = call()
    finally:
        jfn.clear_cache()
        for var in env:
            monkeypatch.delenv(var)
    return out, calls


def _jax_nn_fixed(monkeypatch, ga, gb, n_a, env, **kw):
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted as jnn

    return _jax_traced(monkeypatch, env, jnn, "refine_nn_pallas_t",
                       "_nn_group", lambda: _jax_nn(ga, gb, n_a, **kw))


def _jax_knn_fixed(monkeypatch, ga, gb, n_a, env, **kw):
    from open_pcc_metric_tpu.ops.knn_pruned import knn_pruned_sorted as jknn

    return _jax_traced(monkeypatch, env, jknn, "refine_knn_pallas_t",
                       "refine_knn_pallas",
                       lambda: jax_knn_sorted(ga, gb, n_a, **kw))


def _same_valid_rows(got, want, n):
    for x, y in zip(got, want):
        assert torch.equal(x[:n] if x.ndim else x, y[:n] if y.ndim else y)


@pytest.mark.parametrize("kind,exclude_self", [
    ("int", False), ("int", True), ("float", False),
])
def test_nn_fixed_matches_jax(kind, exclude_self, monkeypatch):
    """3000 queries (12 tiles) under PCC_NN_SCHED=fixed, cap 9 of 12-16
    search chunks, every tile a fallback tile: K2c and one K1b launch, then
    K1 tiers; JAX's straight kernel runs its whole stage 1."""
    a, ga = _grid(_points(kind, 3000, 101 + exclude_self, hi=64))
    b, gb = (a, ga) if exclude_self else _grid(
        _points(kind, 4000, 103, hi=64))
    assert ga.n_chunks == 12 and gb.n_chunks in (12, 16)
    kw = dict(exclude_self=exclude_self, cap=9, fallback_tiles=12)
    calls = _port_spies(monkeypatch)
    got = nn_pruned_sorted(ga, gb, a.n, sched="fixed", **kw)
    assert len(calls["select_candidates"]) == 1
    assert len(calls["refine_nn_straight"]) == 1
    assert calls["refine_nn"] and all(  # the tiers: seeded, gated, compacted
        c[1].get("tiles") is not None for c in calls["refine_nn"])
    want, jcalls = _jax_nn_fixed(monkeypatch, ga, gb, a.n,
                                 {"PCC_NN_SCHED": "fixed"}, **kw)
    assert jcalls and jcalls[0][0][4].shape == (12, 9)
    _check(kind, got, want, ga, gb, a.n, b.n, exclude_self)
    _same_valid_rows(got, nn_pruned_sorted(ga, gb, a.n, **kw), a.n)


def test_nn_cap_at_most_8_takes_the_fixed_schedule(monkeypatch):
    """cap 8 runs the fixed stage 1 under the default PCC_NN_SCHED, in both
    packages."""
    a, ga = _grid(_points("int", 3000, 105))
    b, gb = _grid(_points("int", 3400, 106))
    kw = dict(cap=8, fallback_tiles=12)
    monkeypatch.delenv("PCC_NN_SCHED", raising=False)
    calls = _port_spies(monkeypatch)
    got = nn_pruned_sorted(ga, gb, a.n, **kw)
    assert len(calls["refine_nn_straight"]) == 1
    want, jcalls = _jax_nn_fixed(monkeypatch, ga, gb, a.n, {}, **kw)
    assert jcalls
    _check("int", got, want, ga, gb, a.n, b.n, False)


def test_nn_fixed_ladder_matches_jax(monkeypatch):
    """From rung (9, 1) under PCC_NN_SCHED=fixed: each rung overflows
    exactly when JAX's does, and both certify on the same rung."""
    a, ga = _grid(_points("float", 3000, 107, hi=100))
    b, gb = _grid(_points("float", 4000, 108, hi=100))
    cap, ft = 9, 1
    seen = []
    while True:
        got = nn_pruned_sorted(ga, gb, a.n, cap=cap, fallback_tiles=ft,
                               sched="fixed")
        want, _ = _jax_nn_fixed(monkeypatch, ga, gb, a.n,
                                {"PCC_NN_SCHED": "fixed"}, cap=cap,
                                fallback_tiles=ft)
        assert bool(got[2]) == want[2], (cap, ft)
        seen.append(want[2])
        if not want[2] or cap >= gb.n_chunks:
            break
        cap, ft = next_rung(cap, ft, gb.n_chunks, ga.n_chunks)
    assert seen[0] and not seen[-1]
    _check("float", got, want, ga, gb, a.n, b.n, False)


def _knn_cloud(n, seed, tiles):
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, 48, (n, 3)), axis=0).astype(float)
    return _grid(pts, pad_to=tiles * CHUNK)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_fixed_matches_jax(exclude_self, monkeypatch):
    """Self 30-NN of 10 tiles under PCC_KNN_SCHED=fixed, with the moments
    (K4 over all 10 chunks; under exclude_self the gather sums, after cap
    8 and a K3 tier): K2c and one K3b launch; JAX's straight k-NN kernel
    runs stage 1."""
    a, ga = _knn_cloud(2500, 111 + exclude_self, 10)
    kw = dict(cap=8 if exclude_self else 10, fallback_tiles=10,
              with_moments=True, exclude_self=exclude_self)
    calls = _port_spies(monkeypatch)
    got = knn_pruned_sorted(ga, ga, a.n, K, sched="fixed", **kw)
    assert len(calls["select_candidates"]) == 1
    assert len(calls["refine_knn_straight"]) == 1
    assert bool(calls["refine_knn"]) == exclude_self  # tier A
    want, jcalls = _jax_knn_fixed(monkeypatch, ga, ga, a.n,
                                  {"PCC_KNN_SCHED": "fixed"}, **kw)
    assert jcalls
    assert not want[2]
    if exclude_self:
        assert_matches(got[:3], want[:3], a.n)
        mom = got[3].numpy()[: a.n]
        np.testing.assert_array_equal(mom[:, 0], want[3][: a.n, 0])
        np.testing.assert_allclose(mom, want[3][: a.n], rtol=1e-6, atol=1e-4)
    else:
        assert_matches(got, want, a.n)


def test_knn_sched_env_on_whole_groups_matches_jax(monkeypatch):
    """8 query tiles (one whole group) against all 12 search chunks, cross
    30-NN, PCC_KNN_SCHED=fixed: the port runs K2c and K3b; JAX refines
    stage 1 ungated over all cap chunks; results and overflow equal, and
    equal the counted schedule's probe and extension."""
    a, ga = _knn_cloud(2000, 113, 8)
    b, gb = _knn_cloud(3000, 114, 12)
    kw = dict(cap=12, fallback_tiles=8)
    calls = _port_spies(monkeypatch)
    got = knn_pruned_sorted(ga, gb, a.n, K, sched="fixed", **kw)
    assert len(calls["refine_knn_straight"]) == 1
    jax_on_cpu()
    from open_pcc_metric_tpu.ops import refine_pallas

    stage = _spy(monkeypatch, refine_pallas, "refine_knn_pallas_t")
    want, straight = _jax_knn_fixed(monkeypatch, ga, gb, a.n,
                                    {"PCC_KNN_SCHED": "fixed"}, **kw)
    assert not straight  # whole groups: the transposed kernel, ungated
    first = stage[0]
    assert first[0][3].shape == (8, 12) and first[1].get("ncand") is None
    assert_matches(got, want, a.n)
    _same_valid_rows(got, knn_pruned_sorted(ga, gb, a.n, K, **kw), a.n)


@pytest.mark.parametrize("tiles,cap", [(12, 16), (8, 8)])
def test_knn_counted_on_ragged_tiles_or_small_cap_is_fixed(tiles, cap,
                                                           monkeypatch):
    """Under the default PCC_KNN_SCHED, 12 tiles (nta % 8 != 0) or cap <= 8
    take the fixed stage 1 in both packages (JAX's straight kernel on the
    12 tiles that fill no 8-tile group)."""
    a, ga = _knn_cloud(tiles * 250, 115, tiles)
    kw = dict(cap=cap, fallback_tiles=tiles)
    monkeypatch.delenv("PCC_KNN_SCHED", raising=False)
    calls = _port_spies(monkeypatch)
    got = knn_pruned_sorted(ga, ga, a.n, K, **kw)
    assert len(calls["refine_knn_straight"]) == 1
    assert not calls["refine_knn"] or all(
        c[1].get("tiles") is not None for c in calls["refine_knn"])
    want, jcalls = _jax_knn_fixed(monkeypatch, ga, ga, a.n, {}, **kw)
    assert bool(jcalls) == (tiles == 12)
    assert_matches(got, want, a.n)


def test_fused_under_fixed_equals_default(monkeypatch):
    """fused_evaluate with PCC_NN_SCHED=fixed and PCC_KNN_SCHED=fixed on a
    small pair (16 tiles each) pinned to the pruned search, without normals
    (estimated through the pruned k-NN), both base rungs at cap 12 so the
    default is the counted schedule: K2c, K1b and K3b run, and the table
    equals the default's bit for bit; unset, the next call runs none of
    them."""
    monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    monkeypatch.setenv("PCC_NN_CAP", "12")
    monkeypatch.setenv("PCC_KNN_CAP", "12")
    o, r = _pair_arrays(3)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error",
              backend="pruned")

    def run():
        a, b = (Cloud.from_numpy(x[0], colors=x[1], pad_to=4096,
                                 device="cpu") for x in (o, r))
        return fused_mod.fused_evaluate(a, b, **kw)

    monkeypatch.delenv("PCC_NN_SCHED", raising=False)
    monkeypatch.delenv("PCC_KNN_SCHED", raising=False)
    default = run()
    calls = _port_spies(monkeypatch)
    monkeypatch.setenv("PCC_NN_SCHED", "fixed")
    monkeypatch.setenv("PCC_KNN_SCHED", "fixed")
    got = run()
    # two estimations, then the two cross sweeps (the origin's estimation
    # cached its boundary stats, so no self sweep runs)
    assert len(calls["refine_knn_straight"]) == 2
    assert len(calls["select_candidates"]) == 2 + 2
    assert len(calls["refine_nn_straight"]) == 2
    for key in default:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(default[key]))
    monkeypatch.delenv("PCC_NN_SCHED")
    monkeypatch.delenv("PCC_KNN_SCHED")
    before = {k: len(v) for k, v in calls.items()}
    again = run()
    for name in ("select_candidates", "refine_nn_straight",
                 "refine_knn_straight"):
        assert len(calls[name]) == before[name]
    for key in default:
        np.testing.assert_array_equal(np.asarray(again[key]),
                                      np.asarray(default[key]))


def test_resolve_sched_reads_the_env_at_each_call(monkeypatch):
    for env, fn in (("PCC_NN_SCHED", nn_mod.resolve_nn_sched),
                    ("PCC_KNN_SCHED", nn_mod.resolve_knn_sched)):
        monkeypatch.delenv(env, raising=False)
        assert fn() == "counted"
        for value, want in (("fixed", "fixed"), ("counted", "counted"),
                            ("bogus", "fixed"), ("COUNTED", "fixed")):
            monkeypatch.setenv(env, value)
            assert fn() == want
        assert fn("counted") == "counted"
        with pytest.raises(ValueError):
            fn("bogus")
    # the select prologue needs the counted schedule, as in JAX
    assert nn_mod.uses_select("select", 32, torch.float32)
    assert not nn_mod.uses_select("select", 32, torch.float32, "fixed")


@pytest.mark.cuda
def test_cuda_fixed_schedules_match_cpu():
    """Both fixed schedules on the card against the same calls on the CPU
    (plain versions), valid rows bit for bit; K2c, K1b and K3b launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from open_pcc_metric_tpu_torch.ops import refine

    dev = torch.device("cuda")

    def to(g):
        return type(g)(*(x.to(dev) for x in g))

    a, ga = _grid(_points("float", 3000, 121, hi=64))
    _, gb = _grid(_points("float", 4000, 122, hi=64))
    before = {n: getattr(refine, n).launches for n in (
        "select_candidates", "refine_nn_straight", "refine_knn_straight")}
    for q, s, ex in ((ga, gb, False), (ga, ga, True)):
        kw = dict(exclude_self=ex, cap=9, fallback_tiles=4, sched="fixed")
        want = nn_pruned_sorted(q, s, a.n, **kw)
        got = nn_pruned_sorted(to(q), to(s), a.n, **kw)
        _same_valid_rows([x.cpu() for x in got], want, a.n)
    k, g = _knn_cloud(3000, 123, 12)
    kw = dict(cap=9, fallback_tiles=8, with_moments=True, sched="fixed")
    want = knn_pruned_sorted(g, g, k.n, K, **kw)
    got = knn_pruned_sorted(to(g), to(g), k.n, K, **kw)
    _same_valid_rows([x.cpu() for x in got[:3]], want[:3], k.n)
    torch.testing.assert_close(got[3][: k.n].cpu(), want[3][: k.n],
                               rtol=1e-6, atol=1e-4)
    after = {n: getattr(refine, n).launches for n in before}
    assert after["select_candidates"] == before["select_candidates"] + 3
    assert after["refine_nn_straight"] == before["refine_nn_straight"] + 2
    assert after["refine_knn_straight"] == before["refine_knn_straight"] + 1
