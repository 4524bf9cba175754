"""PyTorch port: the pruned 1-NN schedule against the JAX package.

The JAX side runs ``nn_pruned_sorted(..., refine_impl="pallas_interpret")``,
which drives the count-gated schedule through the Pallas K1 kernel in
interpret mode (as tests/test_pallas.py does). Both packages get the SAME
grid. Integer clouds must agree bit for bit in d and original id, ties
included; float clouds are held to the tolerance rule of
test_torch_refine.py. The overflow flag must agree too.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.nn_pruned import (
    nn_pruned_sorted, unsort_nn_result)
from open_pcc_metric_tpu_torch.ops.refine import refine_nn
from open_pcc_metric_tpu_torch.utils.cache import next_rung

from test_torch_refine import EPS32, assert_float_agree, jax_on_cpu


def _grid(pts, pad_to=None):
    c = Cloud.from_numpy(pts, pad_to=pad_to, device="cpu")
    return c, c.get_grid(build="device")


def _jax_nn(ga, gb, n_a, **kw):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.grid import ChunkGrid as JGrid
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted as jnn

    def jg(g):
        return JGrid(*(jnp.asarray(x.numpy()) for x in g))

    ja = jg(ga)
    jb = ja if gb is ga else jg(gb)
    d, i, ov = jnn(ja, jb, jnp.asarray(n_a), refine_impl="pallas_interpret",
                   **kw)
    return np.asarray(d), np.asarray(i), bool(ov)


def _brute(ga, gb, n_a, n_b, exclude_self):
    """float64 exact NN (lowest original id on ties) of the valid sorted
    f32 query rows, plus the second-best distance for the float rule."""
    q = ga.points[:n_a].double().numpy()
    b = gb.points.double().numpy()[:n_b]
    ids = gb.perm[:n_b].numpy()
    d = ((q[:, None, :] - b[None]) ** 2).sum(-1)
    if exclude_self:
        d[np.arange(n_a), np.arange(n_a)] = np.inf
    d = d[:, np.argsort(ids)]  # columns in original-id order
    part = np.partition(d, 1, axis=1)
    return d.argmin(1), d.min(1), part[:, 1]


def _check(kind, got, want, ga, gb, n_a, n_b, exclude_self):
    d_p, i_p, ov_p = got
    d_j, i_j, ov_j = want
    assert bool(ov_p) == ov_j
    assert not ov_j
    d_p, i_p = d_p[:n_a].numpy(), i_p[:n_a].numpy()
    d_j, i_j = d_j[:n_a], i_j[:n_a]
    oi, od, second = _brute(ga, gb, n_a, n_b, exclude_self)
    if kind == "int":
        np.testing.assert_array_equal(d_p, d_j)
        np.testing.assert_array_equal(i_p, i_j)
        np.testing.assert_array_equal(i_p, oi)
        np.testing.assert_array_equal(d_p, od)
    else:
        assert_float_agree(d_p, i_p, d_j, i_j, od, second)
        sure = (second - od) > 4 * EPS32 * od
        np.testing.assert_array_equal(i_p[sure], oi[sure])


def _points(kind, n, seed, hi=512):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, hi, (n, 3)).astype(np.float64)
    return rng.uniform(0.0, hi, (n, 3))


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_nn_pruned_sorted_matches_jax(kind, exclude_self):
    """Probe + gated extension + tier A (cap 12 of 16 chunks)."""
    a, ga = _grid(_points(kind, 3500, 21), pad_to=4096)
    if exclude_self:
        b, gb = a, ga
    else:
        b, gb = _grid(_points(kind, 3000, 22), pad_to=4096)
    kw = dict(exclude_self=exclude_self, cap=12, fallback_tiles=128)
    got = nn_pruned_sorted(ga, gb, a.n, **kw)
    want = _jax_nn(ga, gb, a.n, **kw)
    _check(kind, got, want, ga, gb, a.n, b.n, exclude_self)


def test_tiers_a_and_b_match_jax():
    """One query tile spread over the whole search cloud qualifies every
    one of its 136 chunks: stage 1 (cap 12) and tier A (128) overflow,
    tier B (136) certifies."""
    a, ga = _grid(_points("int", 100, 23))
    b, gb = _grid(_points("int", 34000, 24), pad_to=136 * CHUNK)
    assert gb.n_chunks == 136
    assert bool(nn_pruned_sorted(ga, gb, a.n, cap=12, fallback_tiles=0)[2])
    kw = dict(cap=12, fallback_tiles=128)
    got = nn_pruned_sorted(ga, gb, a.n, **kw)
    want = _jax_nn(ga, gb, a.n, **kw)
    _check("int", got, want, ga, gb, a.n, b.n, False)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_many_equal_lbs_match_jax(exclude_self):
    """A voxel cloud on an 8^3 lattice has many chunks with the same bbox,
    so equal lower bounds are everywhere; the candidate order and the tier
    tiles must follow XLA's lowest-index tie order (the tiers skip a prefix
    of it), which torch.topk would not promise."""
    a, ga = _grid(_points("int", 3000, 25, hi=8), pad_to=4096)
    if exclude_self:
        b, gb = a, ga
    else:
        b, gb = _grid(_points("int", 2500, 26, hi=8), pad_to=4096)
    kw = dict(exclude_self=exclude_self, cap=9, fallback_tiles=4)
    got = nn_pruned_sorted(ga, gb, a.n, **kw)
    want = _jax_nn(ga, gb, a.n, **kw)
    _check("int", got, want, ga, gb, a.n, b.n, exclude_self)


def test_escalation_from_tiny_cap_matches_jax():
    """cap=1, fallback=1 overflows; each rung of the ladder reports overflow
    exactly as JAX's pallas_interpret schedule does, and the certified rung
    gives the exact answer."""
    a, ga = _grid(_points("float", 2000, 27, hi=100), pad_to=2048)
    b, gb = _grid(_points("float", 3000, 28, hi=100), pad_to=4096)
    cap, ft = 1, 1
    seen = []
    while True:
        got = nn_pruned_sorted(ga, gb, a.n, cap=cap, fallback_tiles=ft)
        want = _jax_nn(ga, gb, a.n, cap=cap, fallback_tiles=ft)
        assert bool(got[2]) == want[2], (cap, ft)
        seen.append(want[2])
        if not want[2] or cap >= gb.n_chunks:
            break
        cap, ft = next_rung(cap, ft, gb.n_chunks, ga.n_chunks)
    assert seen[0] and not seen[-1] and len(seen) > 2
    _check("float", got, want, ga, gb, a.n, b.n, False)


def test_unsort_matches_jax():
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.grid import ChunkGrid as JGrid
    from open_pcc_metric_tpu.ops.nn_pruned import unsort_nn_result as junsort

    a, ga = _grid(_points("int", 1500, 29))
    b, gb = _grid(_points("int", 1200, 30))
    d_s, i_s, _ = nn_pruned_sorted(ga, gb, a.n)
    d, i = unsort_nn_result(ga, gb, d_s, i_s)
    jga = JGrid(*(jnp.asarray(x.numpy()) for x in ga))
    jgb = JGrid(*(jnp.asarray(x.numpy()) for x in gb))
    jd, ji = junsort(jga, jgb, jnp.asarray(d_s.numpy()), jnp.asarray(i_s.numpy()))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # original order: row r is the NN of the r-th input point
    pa, pb = a.host_points, b.host_points
    want = ((pa[:, None, :] - pb[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(i[: a.n].numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
def test_cuda_schedule_matches_cpu(exclude_self):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refine kernel has no CPU mode")
    dev = torch.device("cuda")
    a, ga = _grid(_points("int", 3500, 31), pad_to=4096)
    gb = ga if exclude_self else _grid(_points("int", 3000, 32), pad_to=4096)[1]
    kw = dict(exclude_self=exclude_self, cap=12, fallback_tiles=128)
    want = nn_pruned_sorted(ga, gb, a.n, **kw)

    def to(g):
        return type(g)(*(x.to(dev) for x in g))

    before = refine_nn.launches
    got = nn_pruned_sorted(to(ga), to(gb), a.n, **kw)
    assert refine_nn.launches > before
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert got[0].shape == (a.padded_size,) and got[0].shape[0] % CHUNK == 0
