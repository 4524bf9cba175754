"""PyTorch port: the adaptive 1-NN schedule (K7) and K1's expanded-norm mode
against the JAX package.

The JAX side runs ``adaptive_refine(..., interpret=True)``,
``nn_pruned_adaptive_sorted(..., interpret=True)`` and
``nn_pruned_sorted(refine_impl="adaptive_interpret" / "pallas_interpret",
mxu_ok=True)`` on the CPU. Both packages get the same packed arrays and
grids. Every cloud here is integer-valued within ``MXU_EXACT_MAX_COORD``,
where the expanded-norm distance is exact: d and id must agree bit for bit
on valid rows (sentinel rows are not exact in that form and are never
compared), with each other, with the port's default schedule and with a
float64 brute force. Tables under ``PCC_REFINE_IMPL=adaptive`` equal the
default's bit for bit and JAX's within the fused tests' bars.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_mod
from open_pcc_metric_tpu_torch.ops import refine_adaptive as ra
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.nn_pruned import (
    nn_pruned_adaptive_sorted, nn_pruned_sorted, tile_bounds)
from open_pcc_metric_tpu_torch.ops.refine import (
    expanded_candidates, expanded_queries, refine_nn, refine_nn_reference)

from test_torch_fused import _assert_stats_close, _pair_arrays
from test_torch_nn_pruned import _brute, _grid
from test_torch_refine import jax_on_cpu


def _clouds(name, seed=0):
    """tests/test_adaptive.py's integer datasets (voxel, clusters, plane)."""
    rng = np.random.default_rng(seed)
    if name == "voxel":
        A = rng.integers(0, 512, (4000, 3)).astype(float)
        B = rng.integers(0, 512, (3500, 3)).astype(float)
    elif name == "clusters":
        A = np.round(np.concatenate(
            [rng.normal(loc=rng.uniform(0, 1000, 3), scale=5, size=(500, 3))
             for _ in range(8)]))
        B = np.round(np.concatenate(
            [rng.normal(loc=rng.uniform(0, 1000, 3), scale=5, size=(400, 3))
             for _ in range(8)]))
    else:  # plane
        A = np.concatenate([rng.integers(0, 100, (2000, 2)),
                            np.zeros((2000, 1), dtype=np.int64)], 1).astype(float)
        B = np.concatenate([rng.integers(0, 100, (1500, 2)),
                            np.ones((1500, 1), dtype=np.int64)], 1).astype(float)
    (a, ga), (b, gb) = _grid(A), _grid(B)
    assert a.mxu_exact() and b.mxu_exact()
    return a, ga, b, gb


def _jgrid(g):
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.grid import ChunkGrid as JGrid

    return JGrid(*(jnp.asarray(x.numpy()) for x in g))


def _jax_adaptive_sorted(ga, gb, n_a, **kw):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_adaptive_sorted as jad

    ja = _jgrid(ga)
    jb = ja if gb is ga else _jgrid(gb)
    d, i, ov = jad(ja, jb, jnp.asarray(n_a), interpret=True, **kw)
    return np.asarray(d), np.asarray(i), bool(ov)


def _assert_same(got, want, n, oracle=None):
    """d, id (valid rows) and overflow equal; with ``oracle`` (id, d) the
    rows equal it too."""
    assert bool(got[2]) == bool(want[2])
    d, i = got[0][:n].numpy(), got[1][:n].numpy()
    np.testing.assert_array_equal(d, np.asarray(want[0])[:n])
    np.testing.assert_array_equal(i, np.asarray(want[1])[:n])
    if oracle is not None:
        np.testing.assert_array_equal(i, oracle[0])
        np.testing.assert_array_equal(d, oracle[1])


def _spy(monkeypatch, module, name):
    """Count calls of ``module.name`` (passing them on); returns the list
    of each call's (args, kwargs)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_mxu_gate():
    """tests/test_adaptive.py::test_mxu_gate, and the JAX package agrees."""
    jax_on_cpu()
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    rng = np.random.default_rng(3)
    sets = (rng.integers(0, 1024, (500, 3)).astype(float),
            rng.uniform(0, 100, (500, 3)),
            rng.integers(0, 4096, (500, 3)).astype(float),
            rng.integers(-1600, 1601, (500, 3)).astype(float))
    got = [Cloud.from_numpy(p, device="cpu").mxu_exact() for p in sets]
    assert got == [True, False, False, True]
    assert got == [JCloud.from_numpy(p).mxu_exact() for p in sets]
    c = Cloud.from_numpy(sets[0], device="cpu")
    assert c.mxu_exact() and c._mxu_exact is True  # cached on the cloud


def test_pack_matches_jax():
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops import refine_adaptive as jra

    a, ga, _, _ = _clouds("voxel")
    q = ra.pack_queries(ga.points)
    b = ra.pack_candidates(ga.points, ga.perm)
    jq = jra.pack_queries(jnp.asarray(ga.points.numpy()))
    jb = jra.pack_candidates(jnp.asarray(ga.points.numpy()),
                             jnp.asarray(ga.perm.numpy()))
    n = a.n  # sentinel rows' |q|^2 may round in another order
    np.testing.assert_array_equal(q.numpy()[:, :n], np.asarray(jq)[:, :n])
    np.testing.assert_array_equal(b.numpy().view(np.int32)[:, :n],
                                  np.asarray(jb).view(np.int32)[:, :n])
    np.testing.assert_array_equal(b[5].view(torch.int32).numpy(),
                                  ga.perm.numpy())


@pytest.mark.parametrize("case", ["probe", "seeded gated", "compacted self"])
def test_adaptive_refine_reference_matches_jax(case):
    """K7's plain version against JAX ``adaptive_refine(interpret=True)`` on
    the same packed inputs: a probe, a seeded and gated extension, and a
    compacted P3-style call (tids, full lb order, exclude_self)."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.refine_adaptive import adaptive_refine as jar

    a, ga, _, gb = _clouds("voxel", seed=1)
    gs = ga if case == "compacted self" else gb
    _, _, order = tile_bounds(ga, gs, a.n)
    nta = order.shape[0]
    qhat = ra.pack_queries(ga.points)
    bhat = ra.pack_candidates(gs.points, gs.perm)
    tids = torch.arange(nta, dtype=torch.int32)
    kw = {}
    if case == "probe":
        cand, ncand = order[:, :4], torch.full((nta,), 4, dtype=torch.int32)
    elif case == "seeded gated":
        kw["init"] = ra.adaptive_refine_reference(
            qhat, bhat, order[:, :2].contiguous(),
            torch.full((nta,), 2, dtype=torch.int32), tids)
        cand = order[:, 2:9]
        ncand = torch.from_numpy(np.random.default_rng(2).integers(
            0, 8, nta).astype(np.int32))
        ncand[0] = 0  # a fully gated row keeps its seed
    else:
        tids = torch.tensor([13, 2, 7, 9, 0, 15, 4, 11], dtype=torch.int32)
        cand = order[tids.long()]  # each tile's full lb order
        ncand = torch.tensor([16, 0, 3, 16, 1, 5, 2, 9], dtype=torch.int32)
        kw["exclude_self"] = True
    cand = cand.contiguous()
    got = ra.adaptive_refine_reference(qhat, bhat, cand, ncand, tids, **kw)
    jkw = dict(kw)
    if "init" in kw:
        jkw["init"] = tuple(jnp.asarray(x.numpy()) for x in kw["init"])
    want = jar(jnp.asarray(qhat.numpy()), jnp.asarray(bhat.numpy()),
               jnp.asarray(cand.numpy()), jnp.asarray(ncand.numpy()),
               jnp.asarray(tids.numpy()), interpret=True, **jkw)
    valid = (tids.long()[:, None] * CHUNK + torch.arange(CHUNK)) < a.n
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x[valid].numpy(),
                                      np.asarray(y)[valid.numpy()])
    if "init" in kw:
        assert torch.equal(got[1][0], kw["init"][1][0])
    # the adaptive_refine wrapper is the plain version on CPU tensors
    before = ra.adaptive_refine.launches
    again = ra.adaptive_refine(qhat, bhat, cand, ncand, tids, **kw)
    assert ra.adaptive_refine.launches == before
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.parametrize("name", ["voxel", "clusters", "plane"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_nn_pruned_adaptive_sorted_matches_jax(name, exclude_self):
    """tests/test_adaptive.py::test_adaptive_bitexact_vs_legacy, port vs
    JAX, and both equal to the port's default schedule."""
    a, ga, b, gb = _clouds(name)
    gs, nb = (ga, a.n) if exclude_self else (gb, b.n)
    got = nn_pruned_adaptive_sorted(ga, gs, a.n, exclude_self=exclude_self)
    want = _jax_adaptive_sorted(ga, gs, a.n, exclude_self=exclude_self)
    oi, od, _ = _brute(ga, gs, a.n, nb, exclude_self)
    _assert_same(got, want, a.n, (oi, od))
    assert not want[2]
    default = nn_pruned_sorted(ga, gs, a.n, exclude_self=exclude_self)
    _assert_same(got, [x.numpy() for x in default[:2]] + [default[2]], a.n)


def test_small_budget_overflow_matches_jax():
    """cap=8, ft3=8, p1=2 (test_adaptive.py's small budget): the overflow
    flag and every row equal JAX's; exact whenever it does not overflow."""
    a, ga, b, gb = _clouds("voxel", seed=7)
    kw = dict(cap=8, ft3=8, p1=2)
    got = nn_pruned_adaptive_sorted(ga, gb, a.n, **kw)
    want = _jax_adaptive_sorted(ga, gb, a.n, **kw)
    _assert_same(got, want, a.n)
    if not want[2]:
        oi, od, _ = _brute(ga, gb, a.n, b.n, False)
        np.testing.assert_array_equal(got[0][: a.n].numpy(), od)


def test_tail_pass_matches_jax_and_oracle(monkeypatch):
    """A dense duplicate-heavy ball with cap=2, p1=1, ft3=nta: many tiles
    need P3, which refines them over the rest of their lb order (seeded
    with P2's rows beyond the refined prefix) and makes the result exact
    (test_adaptive.py's tail case)."""
    rng = np.random.default_rng(11)
    a, ga = _grid(rng.integers(0, 24, (3000, 3)).astype(float))
    b, gb = _grid(rng.integers(0, 24, (2600, 3)).astype(float))
    nta = ga.points.shape[0] // CHUNK
    calls = _spy(monkeypatch, nn_mod, "adaptive_refine")
    kw = dict(cap=2, ft3=nta, p1=1)
    got = nn_pruned_adaptive_sorted(ga, gb, a.n, **kw)
    assert len(calls) == 3
    tail_cand, tail_ncand, tail_tids = calls[2][0][2:5]
    assert tail_cand.shape == (nta, gb.n_chunks - 2)  # beyond cap = 2
    assert calls[2][1]["init"] is not None
    assert int((tail_ncand > 0).sum()) > 0  # P3 ran on tiles over cap
    want = _jax_adaptive_sorted(ga, gb, a.n, **kw)
    oi, od, _ = _brute(ga, gb, a.n, b.n, False)
    _assert_same(got, want, a.n, (oi, od))
    assert not got[2]


def test_dispatch_matches_jax_adaptive(monkeypatch):
    """nn_pruned_sorted(refine_impl="adaptive", mxu_ok=True) runs the
    adaptive schedule at JAX's knob mapping (cap max(64, cap), ft3 max(64,
    ft // 4)); without mxu_ok it keeps the default schedule (no K7)."""
    a, ga, b, gb = _clouds("clusters", seed=4)
    calls = _spy(monkeypatch, nn_mod, "adaptive_refine")
    kw = dict(cap=16, fallback_tiles=32)
    got = nn_pruned_sorted(ga, gb, a.n, refine_impl="adaptive", mxu_ok=True,
                           **kw)
    # P1 and P2 (cap 64 covers all 13 chunks, so no P3)
    assert gb.n_chunks == 13 and len(calls) == 2
    assert calls[1][0][2].shape[1] == 13 - 8
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted as jnn

    want = jnn(_jgrid(ga), _jgrid(gb), jnp.asarray(a.n),
               refine_impl="adaptive_interpret", mxu_ok=True, **kw)
    _assert_same(got, want, a.n)
    default = nn_pruned_sorted(ga, gb, a.n, refine_impl="adaptive", **kw)
    assert len(calls) == 2
    _assert_same(default, [x.numpy() for x in got[:2]] + [got[2]], a.n)
    with pytest.raises(ValueError):
        nn_pruned_sorted(ga, gb, a.n, refine_impl="bogus")


def test_resolve_refine_impl_reads_the_env_at_each_call(monkeypatch):
    monkeypatch.delenv("PCC_REFINE_IMPL", raising=False)
    monkeypatch.delenv("PCC_NN_EXPANDED", raising=False)
    assert nn_mod.resolve_refine_impl() == "default"
    for impl, expanded, want in (("adaptive", None, "adaptive"),
                                 ("adaptive", "1", "adaptive"),
                                 ("ADAPTIVE", None, "default"),
                                 ("pallas", "1", "expanded"),
                                 (None, "1", "expanded"),
                                 (None, "true", "default")):
        for var, val in (("PCC_REFINE_IMPL", impl),
                         ("PCC_NN_EXPANDED", expanded)):
            if val is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, val)
        assert nn_mod.resolve_refine_impl() == want
    assert nn_mod.resolve_refine_impl("default") == "default"
    with pytest.raises(ValueError):
        nn_mod.resolve_refine_impl("bogus")


def _jax_expanded_refine(qg, bg, cand, exclude_self):
    """JAX's K1 in expanded mode (interpret) on augmented rows packed as
    its nn_pruned_sorted does (refine_pallas.py:287-298)."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.refine_pallas import refine_nn_pallas_t

    def aug(pts, neg2):
        sq = jnp.sum(pts * pts, axis=1, keepdims=True)
        head = (-2.0 * pts) if neg2 else pts
        return jnp.pad(jnp.concatenate([head, sq], axis=1), ((0, 0), (0, 4)))

    q = jnp.asarray(qg.points.numpy())
    b = jnp.asarray(bg.points.numpy())
    d, i = refine_nn_pallas_t(aug(q, True).T, aug(b, False),
                              jnp.asarray(bg.perm.numpy())[None, :],
                              jnp.asarray(cand.numpy()), cs=1,
                              exclude_self=exclude_self, interpret=True,
                              expanded=True)
    nt = cand.shape[0]
    return np.asarray(d).reshape(nt, CHUNK), np.asarray(i).reshape(nt, CHUNK)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_expanded_refine_matches_jax(exclude_self):
    """K1's expanded mode (plain version) against JAX's K1 with
    ``expanded=True`` and against the difference form: bit-equal on valid
    rows of an integer cloud up to 1023 (test_pallas.py's expanded test)."""
    rng = np.random.default_rng(60)
    a, ga = _grid(rng.integers(0, 1024, (3000, 3)).astype(float), pad_to=4096)
    gb = ga if exclude_self else _grid(
        rng.integers(0, 1024, (2500, 3)).astype(float), pad_to=4096)[1]
    _, _, order = tile_bounds(ga, gb, a.n)
    cand = order[:, :6].contiguous()
    args = (ga.points, gb.points, gb.perm, cand)
    got = refine_nn_reference(*args, exclude_self=exclude_self, expanded=True)
    want = _jax_expanded_refine(ga, gb, cand, exclude_self)
    diff = refine_nn_reference(*args, exclude_self=exclude_self)
    n = a.n
    for x, y, z in zip(got, want, diff):
        np.testing.assert_array_equal(x.reshape(-1)[:n].numpy(),
                                      y.reshape(-1)[:n])
        assert torch.equal(x.reshape(-1)[:n], z.reshape(-1)[:n])
    q4, b4 = expanded_queries(ga.points), expanded_candidates(gb.points)
    assert torch.equal(q4[:, :3], -2.0 * ga.points)
    assert torch.equal(b4[:, :3], gb.points)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_expanded_schedule_matches_jax(exclude_self, monkeypatch):
    """nn_pruned_sorted(refine_impl="expanded", mxu_ok=True) against JAX's
    nn_pruned_sorted with PCC_NN_EXPANDED=1 (read when it traces, so its
    cache is cleared before and after; a spy proves its expanded K1 ran):
    every K1 call of the port's schedule takes the expanded mode, the
    results equal JAX's and the default schedule's."""
    rng = np.random.default_rng(61)
    a, ga = _grid(rng.integers(0, 1024, (3000, 3)).astype(float), pad_to=4096)
    b, gb = (a, ga) if exclude_self else _grid(
        rng.integers(0, 1024, (2500, 3)).astype(float))
    kw = dict(exclude_self=exclude_self, cap=12, fallback_tiles=8)
    calls = _spy(monkeypatch, nn_mod, "refine_nn")
    got = nn_pruned_sorted(ga, gb, a.n, refine_impl="expanded", mxu_ok=True,
                           **kw)
    assert calls and all(c[1]["expanded"] for c in calls)
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops import refine_pallas
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted as jnn

    jcalls = _spy(monkeypatch, refine_pallas, "refine_nn_pallas_t")
    monkeypatch.setenv("PCC_NN_EXPANDED", "1")
    ja = _jgrid(ga)
    jb = ja if gb is ga else _jgrid(gb)
    jnn.clear_cache()
    try:
        want = jnn(ja, jb, jnp.asarray(a.n), refine_impl="pallas_interpret",
                   mxu_ok=True, **kw)
    finally:
        jnn.clear_cache()
        monkeypatch.delenv("PCC_NN_EXPANDED")
    assert any(c[1].get("expanded") for c in jcalls)
    oi, od, _ = _brute(ga, gb, a.n, b.n, exclude_self)
    _assert_same(got, want, a.n, (oi, od))
    default = nn_pruned_sorted(ga, gb, a.n, **kw)
    _assert_same(got, [x.numpy() for x in default[:2]] + [default[2]], a.n)


def _fused_pair(o, r, normals=True):
    def cloud(arrays):
        return Cloud.from_numpy(arrays[0], colors=arrays[1],
                                normals=arrays[2] if normals else None,
                                device="cpu")

    return cloud(o), cloud(r)


KW = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error",
          backend="pruned")


def test_fused_evaluate_adaptive_matches_default_and_jax(monkeypatch):
    """fused_evaluate under PCC_REFINE_IMPL=adaptive on an integer pair:
    K7 runs (the three sweeps' probes and extensions; cap 64 covers every
    chunk, so no tail), the table equals the default's bit for bit and
    JAX's within 1e-4 dB (1e-5 relative)."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused

    o, r = _pair_arrays(1)
    monkeypatch.delenv("PCC_REFINE_IMPL", raising=False)
    want = jfused(JCloud.from_numpy(*o, dtype=jnp.float32, thin=False),
                  JCloud.from_numpy(*r, dtype=jnp.float32, thin=False), **KW)
    default = fused_mod.fused_evaluate(*_fused_pair(o, r), **KW)
    calls = _spy(monkeypatch, nn_mod, "adaptive_refine")
    monkeypatch.setenv("PCC_REFINE_IMPL", "adaptive")
    a, b = _fused_pair(o, r)
    got = fused_mod.fused_evaluate(a, b, **KW)
    assert a.mxu_exact() and b.mxu_exact()
    assert len(calls) == 6
    assert set(got) == set(default)
    for key in default:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(default[key]))
    _assert_stats_close(got, want)
    # the ladder memo keeps the adaptive rung apart from the default's
    assert {k[-2:] for k in fused_mod._LADDER_MEMO} >= {
        ("default", False), ("adaptive", False)}


def test_float_pair_under_adaptive_takes_the_default(monkeypatch):
    """A float pair fails Cloud.mxu_exact: under PCC_REFINE_IMPL=adaptive
    the sweeps (and boundary_stats) never call K7, and the table is the
    default's."""
    o, r = _pair_arrays(2)
    rng = np.random.default_rng(5)
    o = (o[0] + rng.uniform(-0.4, 0.4, o[0].shape), o[1], o[2])
    monkeypatch.delenv("PCC_REFINE_IMPL", raising=False)
    default = fused_mod.fused_evaluate(*_fused_pair(o, r), **KW)
    calls = _spy(monkeypatch, nn_mod, "adaptive_refine")
    monkeypatch.setenv("PCC_REFINE_IMPL", "adaptive")
    a, b = _fused_pair(o, r)
    got = fused_mod.fused_evaluate(a, b, **KW)
    assert not a.mxu_exact() and b.mxu_exact()
    c = _fused_pair(o, r)[0]
    assert float(fused_mod.boundary_stats(c, backend="pruned")[1]) == float(
        got["max_sqrt"])
    assert calls == []
    for key in default:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(default[key]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 and K1's expanded mode have no "
                    "CPU mode")
    return torch.device("cuda")


def _to(g, dev):
    return type(g)(*(x.to(dev) for x in g))


@pytest.mark.cuda
def test_cuda_adaptive_kernel_matches_plain_version(cuda_device):
    """K7 and K1's expanded mode on the card against their plain versions:
    bit for bit on valid rows (the kernels fuse the multiply-adds)."""
    a, ga, _, gb = _clouds("voxel", seed=8)
    ga, gb = _to(ga, cuda_device), _to(gb, cuda_device)
    _, _, order = tile_bounds(ga, gb, a.n)
    _, _, order_s = tile_bounds(ga, ga, a.n)
    nta = order.shape[0]
    qhat = ra.pack_queries(ga.points)
    tids = torch.arange(nta, dtype=torch.int32, device=cuda_device)
    full = torch.full((nta,), 6, dtype=torch.int32, device=cuda_device)
    sub = torch.tensor([3, 0, 15, 8], dtype=torch.int32, device=cuda_device)
    seed = ra.adaptive_refine(qhat, ra.pack_candidates(gb.points, gb.perm),
                              order[:, :2].contiguous(), full, tids)
    calls = [
        (gb, order[:, :6], full, tids, {}),
        (gb, order[:, 2:12], tids % 11, tids, dict(init=seed)),
        (ga, order_s[sub.long()], sub * 3, sub, dict(exclude_self=True)),
    ]
    for g, cand, ncand, rows, kw in calls:
        args = (qhat, ra.pack_candidates(g.points, g.perm), cand.contiguous(),
                ncand, rows)
        before = ra.adaptive_refine.launches
        got = ra.adaptive_refine(*args, **kw)
        torch.cuda.synchronize()
        assert ra.adaptive_refine.launches == before + 1
        want = ra.adaptive_refine_reference(*args, **kw)
        valid = (rows.long()[:, None] * CHUNK
                 + torch.arange(CHUNK, device=cuda_device)) < a.n
        for x, y in zip(got, want):
            assert torch.equal(x[valid].view(torch.int32),
                               y[valid].view(torch.int32))
    for g, cand, ex in ((gb, order[:, :8], False), (ga, order_s[:, :8], True)):
        args = (ga.points, g.points, g.perm, cand.contiguous())
        got = refine_nn(*args, exclude_self=ex, expanded=True)
        want = refine_nn_reference(*args, exclude_self=ex, expanded=True)
        diff = refine_nn(*args, exclude_self=ex)
        for x, y, z in zip(got, want, diff):
            x, y, z = (t.reshape(-1)[: a.n] for t in (x, y, z))
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
def test_cuda_adaptive_schedule_matches_cpu(exclude_self, cuda_device):
    a, ga, _, gb = _clouds("clusters", seed=9)
    gs = ga if exclude_self else gb
    kw = dict(exclude_self=exclude_self, cap=8, ft3=16, p1=2)
    want = nn_pruned_adaptive_sorted(ga, gs, a.n, **kw)
    g_a = _to(ga, cuda_device)
    g_s = g_a if exclude_self else _to(gs, cuda_device)
    before = ra.adaptive_refine.launches
    got = nn_pruned_adaptive_sorted(g_a, g_s, a.n, **kw)
    assert ra.adaptive_refine.launches == before + 3
    assert bool(got[2]) == bool(want[2])
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x[: a.n].cpu(), y[: a.n])
