"""PyTorch port: K1 (the 1-NN refine) against the JAX package's Pallas kernel.

On the CPU ``refine_nn`` runs its plain PyTorch version; the JAX side is
``refine_nn_pallas_t`` in interpret mode. Integer clouds must agree bit for
bit in d and id. Float clouds are held to a tolerance, because XLA:CPU may
contract the distance's multiply-adds into FMAs while eager PyTorch does
not: d within 4*eps*d, and the id equal on every row whose best and
second-best candidate distances differ by more than that.

The CUDA kernel itself is checked against the plain version by the tests
marked ``cuda`` (skipped without a card) and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, refine_nn, refine_nn_reference)

EPS32 = float(np.finfo(np.float32).eps)


def jax_on_cpu():
    """Import jax for a comparison, or skip where it is not installed. The
    JAX side runs on the CPU, as the repo's own tests run it, also where
    tests/conftest.py is not loaded and a GPU backend would be the default."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    return jax


def _cloud(kind, n, seed, pad_to):
    rng = np.random.default_rng(seed)
    if kind == "int":
        pts = rng.integers(0, 64, (n, 3)).astype(np.float64)
    else:
        pts = rng.uniform(0.0, 64.0, (n, 3))
    c = Cloud.from_numpy(pts, pad_to=pad_to, device="cpu")
    return c, c.get_grid(build="device")


def _jax_refine(qg, bg, cand, ncand=None, init=None, exclude_self=False,
                q_cols=None):
    """The JAX Pallas K1 (interpret mode) on the same sorted inputs.

    ``q_cols`` gathers query tiles into a compacted layout, as the JAX
    cross-NN tiers do."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.refine_pallas import refine_nn_pallas_t

    qt8 = jnp.pad(jnp.asarray(qg.points.numpy()), ((0, 0), (0, 5))).T
    if q_cols is not None:
        qt8 = jnp.take(qt8, jnp.asarray(q_cols), axis=1)
    b8r = jnp.pad(jnp.asarray(bg.points.numpy()), ((0, 0), (0, 5)))
    borig = jnp.asarray(bg.perm.numpy())[None, :]
    kw = {}
    if ncand is not None:
        kw["ncand"] = jnp.asarray(ncand.numpy())
    if init is not None:
        kw["init"] = (jnp.asarray(init[0].numpy()), jnp.asarray(init[1].numpy()))
    d, i = refine_nn_pallas_t(qt8, b8r, borig, jnp.asarray(cand.numpy()),
                              exclude_self=exclude_self, interpret=True, cs=1,
                              **kw)
    nt = cand.shape[0]
    return (np.asarray(d).reshape(nt, CHUNK), np.asarray(i).reshape(nt, CHUNK))


def candidate_gaps(qg, bg, cand, tiles=None, ncand=None, init=None,
                   exclude_self=False):
    """(best, second-best) float64 distance per row over the candidates a
    refine call sees (its live chunks, plus the seed), from the f32 inputs."""
    q = qg.points.double().numpy().reshape(-1, CHUNK, 3)
    b = bg.points.double().numpy().reshape(-1, CHUNK, 3)
    nt, w = cand.shape
    tiles = np.arange(nt) if tiles is None else tiles.numpy()
    live = np.full(nt, w) if ncand is None else np.clip(ncand.numpy(), 0, w)
    best = np.empty((nt, CHUNK))
    second = np.empty((nt, CHUNK))
    for t in range(nt):
        chunks = cand[t, : live[t]].numpy()
        pts = b[chunks].reshape(-1, 3)
        d = ((q[tiles[t]][:, None, :] - pts[None]) ** 2).sum(-1)
        if exclude_self:
            gcol = (chunks[:, None] * CHUNK + np.arange(CHUNK)).reshape(-1)
            grow = tiles[t] * CHUNK + np.arange(CHUNK)
            d[grow[:, None] == gcol[None, :]] = np.inf
        if init is not None:
            d = np.concatenate([d, init[0][t].double().numpy()[:, None]], 1)
        d = np.concatenate([d, np.full((CHUNK, 2), np.inf)], 1)
        part = np.partition(d, 1, axis=1)
        best[t], second[t] = part[:, 0], part[:, 1]
    return best, second


def assert_float_agree(d_p, i_p, d_j, i_j, best, second, rows=None):
    """The float-cloud rule: d within 4*eps*d; ids equal where the best
    and second-best candidates are further apart than that."""
    d_p, i_p = np.asarray(d_p, np.float64), np.asarray(i_p)
    d_j, i_j = np.asarray(d_j, np.float64), np.asarray(i_j)
    if rows is not None:
        d_p, i_p, d_j, i_j = d_p[rows], i_p[rows], d_j[rows], i_j[rows]
        best, second = best[rows], second[rows]
    tol = 4 * EPS32 * np.abs(d_j)
    fin = np.isfinite(d_j)
    assert np.array_equal(np.isfinite(d_p), fin)
    assert np.all(np.abs(d_p[fin] - d_j[fin]) <= tol[fin])
    sure = (second - best) > 4 * EPS32 * best
    assert sure.mean() > 0.5  # the check must bite on most rows
    np.testing.assert_array_equal(i_p[sure], i_j[sure])


def _compare(kind, got, want, qg, bg, cand, **kw):
    if kind == "int":
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    else:
        best, second = candidate_gaps(qg, bg, cand, **kw)
        assert_float_agree(got[0], got[1], want[0], want[1], best, second)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_plain_refine_matches_jax(kind):
    _, qg = _cloud(kind, 1900, 1, 2048)
    _, bg = _cloud(kind, 3000, 2, 4096)
    _, _, order = tile_bounds(qg, bg, 1900)
    cand = order[:, :6].contiguous()
    got = refine_nn_reference(qg.points, bg.points, bg.perm, cand)
    _compare(kind, got, _jax_refine(qg, bg, cand), qg, bg, cand)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_gated_seeded_refine_matches_jax(kind):
    """The ncand gate with an init seed (the probe's result)."""
    _, qg = _cloud(kind, 2000, 3, 2048)
    _, bg = _cloud(kind, 3000, 4, 4096)
    _, _, order = tile_bounds(qg, bg, 2000)
    seed = refine_nn_reference(qg.points, bg.points, bg.perm,
                               order[:, :2].contiguous())
    cand = order[:, 2:10].contiguous()
    ncand = torch.from_numpy(
        np.random.default_rng(5).integers(0, 9, cand.shape[0]).astype(np.int32))
    ncand[0] = 0  # a fully gated tile keeps its seed
    got = refine_nn_reference(qg.points, bg.points, bg.perm, cand,
                              ncand=ncand, init=seed)
    want = _jax_refine(qg, bg, cand, ncand=ncand, init=seed)
    _compare(kind, got, want, qg, bg, cand, ncand=ncand, init=seed)
    assert torch.equal(got[0][0], seed[0][0]) and torch.equal(got[1][0], seed[1][0])


@pytest.mark.parametrize("kind", ["int", "float"])
def test_exclude_self_matches_jax(kind):
    _, g = _cloud(kind, 2000, 6, 2048)
    _, _, order = tile_bounds(g, g, 2000)
    cand = order[:, :5].contiguous()
    got = refine_nn_reference(g.points, g.points, g.perm, cand,
                              exclude_self=True)
    want = _jax_refine(g, g, cand, exclude_self=True)
    _compare(kind, got, want, g, g, cand, exclude_self=True)
    assert not np.any(got[1].reshape(-1)[:2000].numpy()
                      == g.perm[:2000].numpy())


@pytest.mark.parametrize("exclude_self", [False, True])
def test_compacted_tiles_match_jax(exclude_self):
    """``tiles`` reads compacted tier rows in place. Cross: against the JAX
    tier layout (query columns gathered, as nn_pruned does for cross-NN).
    Self: against the JAX kernel on the full tile range, whose global row
    ids are the ones ``tiles`` must reproduce."""
    _, qg = _cloud("int", 4000, 7, 4096)
    bg = qg if exclude_self else _cloud("int", 3000, 8, 4096)[1]
    _, _, order = tile_bounds(qg, bg, 4000)
    seed = refine_nn_reference(qg.points, bg.points, bg.perm,
                               order[:, :1].contiguous(),
                               exclude_self=exclude_self)
    tiles = torch.tensor([13, 2, 7, 9, 0, 15, 4, 11], dtype=torch.int32)
    tl = tiles.long()
    cand = order[tl, :6].contiguous()
    ncand = torch.tensor([6, 0, 3, 6, 1, 5, 2, 6], dtype=torch.int32)
    init = (seed[0][tl].contiguous(), seed[1][tl].contiguous())
    got = refine_nn_reference(qg.points, bg.points, bg.perm, cand, tiles=tiles,
                              ncand=ncand, init=init, exclude_self=exclude_self)
    if exclude_self:
        full_ncand = torch.zeros(order.shape[0], dtype=torch.int32)
        full_ncand[tl] = ncand
        full = _jax_refine(qg, bg, order[:, :6].contiguous(), ncand=full_ncand,
                           init=seed, exclude_self=True)
        want = (full[0][tiles.numpy()], full[1][tiles.numpy()])
    else:
        cols = (tiles.numpy()[:, None] * CHUNK + np.arange(CHUNK)).reshape(-1)
        want = _jax_refine(qg, bg, cand, ncand=ncand, init=init, q_cols=cols)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_duplicate_points_lowest_id_wins():
    """Every search point appears three times: ties go to the lowest
    original id, in the plain version and in the JAX kernel alike."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 32, (600, 3)).astype(np.float64)
    pts_b = np.concatenate([base, base, base])[rng.permutation(1800)]
    q = Cloud.from_numpy(rng.integers(0, 32, (1500, 3)).astype(np.float64),
                         pad_to=2048, device="cpu")
    b = Cloud.from_numpy(pts_b, pad_to=2048, device="cpu")
    qg, bg = q.get_grid(build="device"), b.get_grid(build="device")
    cand = torch.arange(bg.n_chunks, dtype=torch.int32).repeat(
        qg.n_chunks, 1)  # every chunk: the exact NN
    got = refine_nn_reference(qg.points, bg.points, bg.perm, cand)
    want = _jax_refine(qg, bg, cand)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    # against a float64 brute force with lowest-index ties
    qs = qg.points.double().numpy()[:1500]
    d = ((qs[:, None, :] - pts_b[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got[1].reshape(-1)[:1500].numpy(),
                                  d.argmin(1))


def test_cpu_dispatch_and_validation():
    """On CPU tensors refine_nn IS the plain version and counts no launch;
    malformed inputs raise."""
    _, qg = _cloud("int", 500, 12, 512)
    _, _, order = tile_bounds(qg, qg, 500)
    cand = order[:, :2].contiguous()
    before = refine_nn.launches
    got = refine_nn(qg.points, qg.points, qg.perm, cand, exclude_self=True)
    want = refine_nn_reference(qg.points, qg.points, qg.perm, cand,
                               exclude_self=True)
    assert refine_nn.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        refine_nn(qg.points, qg.points, qg.perm, cand.long())
    with pytest.raises(ValueError):
        refine_nn(qg.points[:300], qg.points, qg.perm, cand)
    # fully gated tiles without a seed keep (inf, INT_MAX)
    d, i = refine_nn(qg.points, qg.points, qg.perm, cand,
                     ncand=torch.zeros(cand.shape[0], dtype=torch.int32))
    assert torch.all(torch.isinf(d)) and torch.all(i == INT_MAX)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refine kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
def test_cuda_kernel_matches_plain_version(kind, cuda_device):
    """K1 on the card against refine_nn_reference on the same card: bit for
    bit in every mode (plain, gated + seeded, compacted tiles, self)."""
    _, qg = _cloud(kind, 4000, 13, 4096)
    _, bg = _cloud(kind, 3000, 14, 4096)
    qg = type(qg)(*(x.to(cuda_device) for x in qg))
    bg = type(bg)(*(x.to(cuda_device) for x in bg))
    _, _, order = tile_bounds(qg, bg, 4000)
    _, _, order_s = tile_bounds(qg, qg, 4000)
    seed = refine_nn(qg.points, bg.points, bg.perm, order[:, :2].contiguous())
    tiles = torch.tensor([3, 0, 15, 8], dtype=torch.int32, device=cuda_device)
    tl = tiles.long()
    calls = [
        (bg, order[:, :8], {}),
        (bg, order[:, 2:12], dict(
            ncand=torch.arange(16, dtype=torch.int32, device=cuda_device) % 11,
            init=seed)),
        (bg, order[tl, 2:9], dict(
            tiles=tiles, init=(seed[0][tl].contiguous(), seed[1][tl].contiguous()))),
        (qg, order_s[:, :6], dict(exclude_self=True)),
        (qg, order_s[tl, :6], dict(tiles=tiles, exclude_self=True)),
    ]
    for sg, cand, kw in calls:
        args = (qg.points, sg.points, sg.perm, cand.contiguous())
        before = refine_nn.launches
        dk, ik = refine_nn(*args, **kw)
        torch.cuda.synchronize()
        assert refine_nn.launches == before + 1
        dr, ir = refine_nn_reference(*args, **kw)
        assert torch.equal(dk.view(torch.int32), dr.view(torch.int32))
        assert torch.equal(ik, ir)


@pytest.mark.cuda
def test_cuda_kernel_rejects_float64(cuda_device):
    _, qg = _cloud("int", 500, 15, 512)
    p = qg.points.to(cuda_device, torch.float64)
    perm = qg.perm.to(cuda_device)
    cand = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        refine_nn(p, p, perm, cand)
