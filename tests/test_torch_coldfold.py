"""PyTorch port: the cold-pair fold (``fused.cold_pair_program``) against the
stepwise path and the JAX package's fold, the mirror of
tests/test_coldfold.py.

``fused_evaluate`` routes pruned pairs with cold per-cloud state through
the fold: its tables equal the stepwise path's (rtol 1e-6) and the JAX
package's fold (PSNRs within 1e-4 dB, the rest rtol 1e-6), it reads back
once, fills every per-cloud cache, falls back stepwise on an overflow with
the rung memos as the JAX package leaves them, and stores the estimation
rung only under the shape that demanded it. The fold is taken exactly where
the JAX package takes it. Clouds of 4000 points reach the pruned paths
through the estimation's pruning threshold lowered to 1024 in both
packages, as the JAX package's tests lower it.
"""
import functools
import os

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud, synthetic_voxel_pair
from open_pcc_metric_tpu_torch.ops import fused
from open_pcc_metric_tpu_torch.ops import normals as nops

from test_torch_refine import jax_on_cpu

PSNR_TOL = 1e-4
KW = dict(color_scheme="ycc", point_to_plane=True, backend="pruned")


@pytest.fixture(autouse=True, scope="module")
def _module_setup():
    """The estimation threshold lowered in both packages for the module
    (the shared results below are computed under it), and a worker's share
    of torch's threads under pytest-xdist."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops import normals as jnops

    mp = pytest.MonkeyPatch()
    mp.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    mp.setattr(jnops, "_PRUNE_THRESHOLD", 1024)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)
    mp.undo()


@pytest.fixture(autouse=True)
def fresh_memos(monkeypatch):
    """Fresh ladders, so rungs remembered by other tests do not leak in."""
    monkeypatch.setattr(nops, "_LADDER_MEMO", {})
    monkeypatch.setattr(fused, "_LADDER_MEMO", {})


def _pair(seed=11, n=4000):
    a, b = synthetic_voxel_pair(n, dtype=torch.float32, seed=seed,
                                device="cpu")
    if a.n > b.n:  # reference D2 needs n_origin <= n_reconst
        a, b = b, a
    return a, b


def _stepwise(a, b, monkeypatch=None, **kw):
    """``fused_evaluate`` with the fold switched off, as the JAX package's
    tests switch it off."""
    mp = monkeypatch or pytest.MonkeyPatch()
    mp.setattr(fused, "_cold_fold_applicable", lambda *a_, **k_: False)
    try:
        return fused.fused_evaluate(a, b, **kw)
    finally:
        if monkeypatch is None:
            mp.undo()


@functools.lru_cache(maxsize=None)
def _step_tables(seed):
    """Stepwise tables of one pair, both D2 modes (the second call finds
    the estimated normals cached: the tables do not depend on it)."""
    a, b = _pair(seed)
    return {mode: _stepwise(a, b, d2_mode=mode, **KW)
            for mode in ("reference", "pc_error")}


def _fold_spies(monkeypatch):
    """Count fold entries, programs and readbacks (``_to_host`` calls that
    carry device tensors)."""
    seen = {"fold": 0, "program": [], "readbacks": 0}
    cold, program, to_host = (fused._fused_evaluate_cold,
                              fused.cold_pair_program, fused._to_host)

    def cold_spy(*a, **k):
        seen["fold"] += 1
        return cold(*a, **k)

    def program_spy(*a, **k):
        seen["program"].append(k)
        return program(*a, **k)

    def host_spy(stats):
        seen["readbacks"] += any(isinstance(v, torch.Tensor)
                                 for v in stats.values())
        return to_host(stats)

    monkeypatch.setattr(fused, "_fused_evaluate_cold", cold_spy)
    monkeypatch.setattr(fused, "cold_pair_program", program_spy)
    monkeypatch.setattr(fused, "_to_host", host_spy)
    return seen


def _assert_close(got, want, rtol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("d2_mode", ["reference", "pc_error"])
def test_cold_fold_matches_stepwise(d2_mode, monkeypatch):
    a1, b1 = _pair()
    seen = _fold_spies(monkeypatch)
    res_fold = fused.fused_evaluate(a1, b1, d2_mode=d2_mode, **KW)
    assert seen["fold"] == 1 and len(seen["program"]) == 1
    assert seen["readbacks"] == 1  # the fold certified: one round trip
    for c in (a1, b1):  # the fold filled every per-cloud cache
        assert c._grid is not None and c._est_normals is not None
        assert c._sorted_normals is not None
        assert c._sorted_colors is not None
        assert c._boundary_stats is not None
    _assert_close(res_fold, _step_tables(11)[d2_mode])
    # a warm rerun (caches filled by the fold) stays stepwise and equal
    res_warm = fused.fused_evaluate(a1, b1, d2_mode=d2_mode, **KW)
    assert seen["fold"] == 1
    _assert_close(res_warm, res_fold)


def test_cold_fold_normals_match_stepwise():
    a1, b1 = _pair(seed=5)
    fused.fused_evaluate(a1, b1, point_to_plane=True, backend="pruned")
    a2, _ = _pair(seed=5)
    nrm_step = nops.estimate_normals_cloud(a2)
    np.testing.assert_allclose(a1._est_normals.numpy(), nrm_step.numpy(),
                               atol=2e-6)
    # the sorted normals each path cached are its estimate in grid order
    for c in (a1, a2):
        assert torch.equal(c._sorted_normals,
                           c.get_normals()[c.get_grid().perm.long()])


def test_cold_fold_overflow_falls_back(monkeypatch):
    """A certificate overflow inside the fold falls back stepwise and still
    gives exact results; the fold stores no rung (the stepwise ladders
    store theirs once)."""
    a, b = _pair()
    calls = {"fold": 0}
    program = fused.cold_pair_program

    def always_overflow(*args, **kw):
        calls["fold"] += 1
        stats, cache = program(*args, **kw)
        stats = dict(stats)
        stats["nn_overflow"] = torch.ones((), dtype=torch.bool)
        return stats, cache

    monkeypatch.setattr(fused, "cold_pair_program", always_overflow)
    res = fused.fused_evaluate(a, b, d2_mode="reference", **KW)
    assert calls["fold"] == 1
    _assert_close(res, _step_tables(11)["reference"])
    # the memos hold the stepwise path's stores alone: the fused ladder's
    # once, the estimation's twice (two clouds of one shape); a store by
    # the fold would add one use to each
    assert [uses for _, uses in fused._LADDER_MEMO.values()] == [0]
    assert [uses for _, uses in nops._LADDER_MEMO.values()] == [1]


def _with_unit_normals(c):
    nrm = torch.zeros((c.padded_size, 3), dtype=torch.float32)
    nrm[:, 2] = 1.0
    c.normals = nrm
    return c


def test_fold_taken_with_file_normals_cold_state(monkeypatch):
    """File normals with cold device state fold too, estimating nothing;
    a warm pair keeps the stepwise path."""
    a, b = map(_with_unit_normals, _pair(seed=3))
    seen = _fold_spies(monkeypatch)
    res_fold = fused.fused_evaluate(a, b, **KW)
    est = [(k["est_a"], k["est_b"]) for k in seen["program"]]
    assert est == [(False, False)]
    for c in (a, b):
        assert c._grid is not None and c._sorted_colors is not None
    assert a._boundary_stats is not None
    res_warm = fused.fused_evaluate(a, b, **KW)
    assert seen["fold"] == 1
    a2, b2 = map(_with_unit_normals, _pair(seed=3))
    res_step = _stepwise(a2, b2, monkeypatch, **KW)
    _assert_close(res_fold, res_step)
    _assert_close(res_warm, res_step)


def test_fold_taken_geometry_only_cold_state(monkeypatch):
    """point_to_plane=False pairs with cold state fold (no normals
    anywhere) and match the stepwise values."""
    a, b = _pair(seed=9)
    seen = _fold_spies(monkeypatch)
    kw = dict(color_scheme="ycc", point_to_plane=False, backend="pruned")
    res_fold = fused.fused_evaluate(a, b, **kw)
    assert [(k["est_a"], k["est_b"]) for k in seen["program"]] == [
        (False, False)]
    a2, b2 = _pair(seed=9)
    _assert_close(res_fold, _stepwise(a2, b2, monkeypatch, **kw))


def test_partial_fold_sweep_shape(monkeypatch):
    """A sweep's steady state: the reference cloud fully cached, only the
    degraded cloud estimates, still in one fold."""
    a, b1 = _pair(seed=21)
    fused.fused_evaluate(a, b1, **KW)
    assert a._est_normals is not None
    _, b2 = _pair(seed=22)
    seen = _fold_spies(monkeypatch)
    res_fold = fused.fused_evaluate(a, b2, **KW)
    assert [(k["est_a"], k["est_b"]) for k in seen["program"]] == [
        (False, True)]
    assert seen["readbacks"] == 1
    assert b2._est_normals is not None
    a2, _ = _pair(seed=21)
    _, b3 = _pair(seed=22)
    _assert_close(res_fold, _stepwise(a2, b3, monkeypatch, **KW))


def _jax_pair(seed=11, n=4000):
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import synthetic_voxel_pair as jpair

    a, b = jpair(n, dtype=jnp.float32, seed=seed)
    return (b, a) if a.n > b.n else (a, b)


def test_fold_matches_jax_fold(monkeypatch):
    """The port's fold against the JAX package's ``fused_evaluate``, which
    takes its own fold on the same pair (spies on both): PSNRs within
    1e-4 dB, the rest within rtol 1e-6."""
    from open_pcc_metric_tpu.ops import fused as jfused
    from open_pcc_metric_tpu.ops import normals as jnops

    monkeypatch.setattr(jnops, "_LADDER_MEMO", {})
    monkeypatch.setattr(jfused, "_LADDER_MEMO", {})
    taken = []
    jcold = jfused._fused_evaluate_cold

    def jspy(*a, **k):
        taken.append("jax")
        return jcold(*a, **k)

    monkeypatch.setattr(jfused, "_fused_evaluate_cold", jspy)
    seen = _fold_spies(monkeypatch)
    ja, jb = _jax_pair()
    want = jfused.fused_evaluate(ja, jb, d2_mode="pc_error", **KW)
    a, b = _pair()
    got = fused.fused_evaluate(a, b, d2_mode="pc_error", **KW)
    assert taken == ["jax"] and seen["fold"] == 1
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        if "psnr" in k:
            assert np.max(np.abs(g - w)) <= PSNR_TOL, (k, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)


def _states():
    """(name, build) pairs of equivalent clouds in both packages: each
    build returns the port's pair and the JAX package's, in one state."""
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    rng = np.random.default_rng(4)
    big = np.unique(rng.integers(0, 64, (3000, 3)), axis=0).astype(float)
    small, mid = big[:20], big[:700]
    col = rng.uniform(0, 1, big.shape)
    nrm = np.tile([0.0, 0.0, 1.0], (len(big), 1))

    def both(pts, colors=None, normals=None, pad_to=None):
        return (Cloud.from_numpy(pts, colors, normals, pad_to=pad_to,
                                 device="cpu"),
                JCloud.from_numpy(pts, colors, normals, jnp.float32, pad_to,
                                  thin=False))

    def pair(**kw):
        (a, ja), (b, jb) = both(big, **kw), both(big + 1.0, **kw)
        return (a, b), (ja, jb)

    def grid(c):
        """The grid built; the JAX package's cloud also gets the qt8 pack
        that its fold builds with the grid (the port has none)."""
        c.get_grid()
        if isinstance(c, JCloud):
            c._qt8 = c.points
        return c

    def warm(p):
        for c in p:
            grid(c)
            if c.colors is not None:
                c._sorted_colors = c.colors
        return p

    def est_cached(p):
        for c in p:
            c._est_normals = c.points
        return p

    small_pair = lambda: tuple(zip(both(small, pad_to=4096),  # noqa: E731
                                   both(big, pad_to=4096)))
    return [
        ("cold, no normals", lambda: pair(colors=col)),
        ("cold, file normals", lambda: pair(colors=col, normals=nrm)),
        ("warm, file normals", lambda: tuple(map(warm, pair(
            colors=col, normals=nrm)))),
        ("warm, estimated normals", lambda: tuple(map(
            lambda p: est_cached(warm(p)), pair(colors=col)))),
        ("warm grids, cold colours", lambda: tuple(
            tuple(map(grid, p)) for p in pair(colors=col))),
        ("fewer than k points", small_pair),
        ("below the threshold", lambda: tuple(zip(both(mid, pad_to=768),
                                                  both(big, pad_to=4096)))),
    ]


@pytest.mark.parametrize("point_to_plane", [True, False])
@pytest.mark.parametrize("color_scheme", ["ycc", None])
def test_fold_taken_where_jax_takes_it(point_to_plane, color_scheme):
    """The port's ``_cold_fold_applicable`` against the JAX package's for
    the same pairs in the same cache states (cold; file normals cold and
    warm; estimated normals cached; grids without sorted colours; fewer
    than k points; below the threshold), the pruned backend and another."""
    from open_pcc_metric_tpu.ops import fused as jfused

    for name, build in _states():
        (a, b), (ja, jb) = build()
        for backend, jbackend in (("pruned", "pruned"), ("brute", "jnp")):
            got = fused._cold_fold_applicable(a, b, color_scheme,
                                              point_to_plane, backend)
            want = jfused._cold_fold_applicable(ja, jb, color_scheme,
                                                point_to_plane, jbackend)
            assert got == want, (name, backend)


def test_rung_storage_rule(monkeypatch):
    """Clouds of two padded shapes (4096 and 8192 rows): the fold estimates
    both at max(rung_a, rung_b) and stores that rung only under the shape
    that demanded it; the other shape's entry is left as it was."""
    rng = np.random.default_rng(8)
    pa = np.unique(rng.integers(0, 64, (3900, 3)), axis=0).astype(float)
    a = Cloud.from_numpy(pa, pad_to=4096, device="cpu")
    b = Cloud.from_numpy(pa + 0.5, pad_to=8192, device="cpu")
    nops._LADDER_MEMO[(8192, 30)] = ((128, 512), 5)
    seen = _fold_spies(monkeypatch)
    fused.fused_evaluate(a, b, point_to_plane=True, backend="pruned")
    prog = seen["program"]
    assert len(prog) == 1 and (prog[0]["knn_cap"], prog[0]["knn_ft"]) == (
        128, 512)
    assert prog[0]["est_a"] and prog[0]["est_b"]
    assert nops._LADDER_MEMO[(8192, 30)] == ((128, 512), 6)
    assert (4096, 30) not in nops._LADDER_MEMO
