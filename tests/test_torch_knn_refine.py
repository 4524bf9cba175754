"""PyTorch port: K3 (the k-NN refine) and K4 (the k-NN moment sums) against
the JAX package's Pallas kernels.

On the CPU ``refine_knn`` and ``knn_moments`` run their plain PyTorch
versions; the JAX side is ``refine_knn_pallas_t`` / ``moments_pallas_t`` in
interpret mode, on the same sorted inputs (the port's (nt, 256, k) buffers
are the JAX kernels' (P, k) rows reshaped). Integer clouds, with many
exactly tied distances, must agree bit for bit in d and id. Float clouds
are held to the rule of test_torch_refine.py: d within 4*eps*d, ids equal
on every row whose k+1 smallest candidate distances are further apart than
that. K4's member count must be equal; the other sums agree within
rtol=1e-6, atol=1e-4 (the JAX package's own bar): the two sum in another
order.

The CUDA kernels are checked against the plain versions by the tests
marked ``cuda`` (skipped without a card) and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned_sorted
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, MOM_CH, knn_moments, knn_moments_reference, refine_knn,
    refine_knn_reference)

from test_torch_knn_pruned import assert_matches, jax_knn_sorted
from test_torch_refine import EPS32, jax_on_cpu

K = 30
N_TILES = 16


def _grid(kind, n, seed, pad_to=N_TILES * CHUNK, hi=64):
    rng = np.random.default_rng(seed)
    if kind == "int":
        pts = rng.integers(0, hi, (n, 3)).astype(np.float64)
    else:
        pts = rng.uniform(0.0, hi, (n, 3))
    c = Cloud.from_numpy(pts, pad_to=pad_to, device="cpu")
    return c.get_grid(build="device")


def _distinct_rows(cand, ncand=None):
    """The plain versions' precondition: no chunk twice in a live row."""
    for t, row in enumerate(cand.tolist()):
        live = row if ncand is None else row[: int(ncand[t])]
        assert len(set(live)) == len(live)


def _jax_inputs(qg, bg, q_cols=None):
    jax_on_cpu()
    import jax.numpy as jnp

    qt8 = jnp.pad(jnp.asarray(qg.points.numpy()), ((0, 0), (0, 5))).T
    if q_cols is not None:
        qt8 = jnp.take(qt8, jnp.asarray(q_cols), axis=1)
    b8r = jnp.pad(jnp.asarray(bg.points.numpy()), ((0, 0), (0, 5)))
    return qt8, b8r, jnp.asarray(bg.perm.numpy())[None, :]


def _rows(x, k):
    return None if x is None else x.reshape(-1, k).numpy()


def jax_knn(qg, bg, cand, k=K, ncand=None, init=None, exclude_self=False,
            q_cols=None):
    """The JAX Pallas K3 (interpret mode), as (nt, 256, k) numpy."""
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.refine_pallas import refine_knn_pallas_t

    qt8, b8r, borig = _jax_inputs(qg, bg, q_cols)
    kw = {}
    if ncand is not None:
        kw["ncand"] = jnp.asarray(ncand.numpy())
    if init is not None:
        kw["init"] = (jnp.asarray(_rows(init[0], k)),
                      jnp.asarray(_rows(init[1], k)))
    d, i = refine_knn_pallas_t(qt8, b8r, borig, jnp.asarray(cand.numpy()), k,
                               exclude_self=exclude_self, interpret=True, **kw)
    nt = cand.shape[0]
    return (np.asarray(d).reshape(nt, CHUNK, k),
            np.asarray(i).reshape(nt, CHUNK, k))


def jax_moments(qg, bg, cand, ncand, rk, ik, init=None, q_cols=None):
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.refine_pallas import moments_pallas_t

    qt8, b8r, borig = _jax_inputs(qg, bg, q_cols)
    mom = moments_pallas_t(
        qt8, b8r, borig, jnp.asarray(cand.numpy()),
        jnp.asarray(ncand.numpy()), jnp.asarray(rk.numpy()),
        jnp.asarray(ik.numpy()),
        init=None if init is None else jnp.asarray(_rows(init, MOM_CH)),
        interpret=True)
    return np.asarray(mom).reshape(cand.shape[0], CHUNK, MOM_CH)


def sure_rows(qg, bg, cand, k, tiles=None, ncand=None, init=None):
    """(nt, 256) mask of the rows whose k+1 smallest float64 candidate
    distances (live chunks plus the seed) are pairwise further apart than
    4*eps*d: there the k-set and its order cannot depend on rounding."""
    q = qg.points.double().numpy().reshape(-1, CHUNK, 3)
    b = bg.points.double().numpy().reshape(-1, CHUNK, 3)
    nt, w = cand.shape
    tiles = np.arange(nt) if tiles is None else tiles.numpy()
    live = np.full(nt, w) if ncand is None else np.clip(ncand.numpy(), 0, w)
    sure = np.empty((nt, CHUNK), bool)
    for t in range(nt):
        pts = b[cand[t, : live[t]].numpy()].reshape(-1, 3)
        d = ((q[tiles[t]][:, None, :] - pts[None]) ** 2).sum(-1)
        if init is not None:
            d = np.concatenate([d, init[0][t].double().numpy()], 1)
        d = np.sort(np.concatenate([d, np.full((CHUNK, k + 1), np.inf)], 1),
                    axis=1)[:, : k + 1]
        fin = np.isfinite(d[:, 1:])
        gaps = np.where(fin, d[:, 1:] - d[:, :-1] > 4 * EPS32 * d[:, 1:], True)
        sure[t] = gaps.all(axis=1)
    return sure


def assert_knn_agree(kind, got, want, sure=None):
    d_p, i_p = got[0].numpy(), got[1].numpy()
    d_j, i_j = want
    if kind == "int":
        np.testing.assert_array_equal(d_p, d_j)
        np.testing.assert_array_equal(i_p, i_j)
        return
    fin = np.isfinite(d_j)
    assert np.array_equal(np.isfinite(d_p), fin)
    tol = 4 * EPS32 * np.abs(d_j[fin].astype(np.float64))
    assert np.all(np.abs(d_p[fin].astype(np.float64) - d_j[fin]) <= tol)
    assert sure.mean() > 0.5  # the check must bite on most rows
    np.testing.assert_array_equal(i_p[sure], i_j[sure])


def assert_moments_agree(got, want):
    got = got.numpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def _probe_and_extension(kind, exclude_self=False):
    """A probe of 4 chunks, then a gated extension over the next 6 seeded
    from it (tile 0 fully gated, so it keeps its seed)."""
    qg = _grid(kind, 3800, 1)
    bg = qg if exclude_self else _grid(kind, 3500, 2)
    _, _, order = tile_bounds(qg, bg, 3800)
    probe = order[:, :4].contiguous()
    ext = order[:, 4:10].contiguous()
    ncand = torch.from_numpy(np.random.default_rng(3).integers(
        0, 7, N_TILES).astype(np.int32))
    ncand[0] = 0
    return qg, bg, probe, ext, ncand


@pytest.mark.parametrize("kind", ["int", "float"])
def test_knn_probe_and_seeded_extension_match_jax(kind):
    """The ungated probe, then the gated extension seeded from it."""
    qg, bg, probe, ext, ncand = _probe_and_extension(kind)
    _distinct_rows(torch.cat([probe, ext], 1), ncand + probe.shape[1])
    seed = refine_knn_reference(qg.points, bg.points, bg.perm, probe, K)
    assert_knn_agree(kind, seed, jax_knn(qg, bg, probe),
                     sure_rows(qg, bg, probe, K) if kind == "float" else None)
    got = refine_knn_reference(qg.points, bg.points, bg.perm, ext, K,
                               ncand=ncand, init=seed)
    want = jax_knn(qg, bg, ext, ncand=ncand, init=seed)
    sure = (sure_rows(qg, bg, ext, K, ncand=ncand, init=seed)
            if kind == "float" else None)
    assert_knn_agree(kind, got, want, sure)
    assert torch.equal(got[0][0], seed[0][0]) and torch.equal(got[1][0], seed[1][0])
    # ascending and, on the int cloud, full of exact ties broken by id
    d, i = got[0].numpy(), got[1].numpy()
    assert np.all(np.diff(d, axis=2) >= 0)
    if kind == "int":
        tie = np.diff(d, axis=2) == 0
        assert tie.mean() > 0.2
        assert np.all(np.diff(i, axis=2)[tie] > 0)


def test_knn_compacted_tier_matches_jax():
    """``tiles`` reads a compacted tier's queries in place: against the JAX
    tier layout (query columns gathered, as knn_pruned does)."""
    qg, bg, probe, _, _ = _probe_and_extension("int")
    _, _, order = tile_bounds(qg, bg, 3800)
    seed = refine_knn_reference(qg.points, bg.points, bg.perm, probe, K)
    tiles = torch.tensor([13, 2, 7, 9, 0, 15, 4, 11], dtype=torch.int32)
    tl = tiles.long()
    cand = order[tl, 4:12].contiguous()
    ncand = torch.tensor([8, 0, 3, 8, 1, 5, 2, 8], dtype=torch.int32)
    init = (seed[0][tl].contiguous(), seed[1][tl].contiguous())
    got = refine_knn_reference(qg.points, bg.points, bg.perm, cand, K,
                               tiles=tiles, ncand=ncand, init=init)
    cols = (tiles.numpy()[:, None] * CHUNK + np.arange(CHUNK)).reshape(-1)
    want = jax_knn(qg, bg, cand, ncand=ncand, init=init, q_cols=cols)
    assert_knn_agree("int", got, want)
    # the same rows as a full-range call that gates every other tile off
    full_n = torch.zeros(N_TILES, dtype=torch.int32)
    full_n[tl] = ncand
    full = refine_knn_reference(qg.points, bg.points, bg.perm,
                                order[:, 4:12].contiguous(), K, ncand=full_n,
                                init=seed)
    assert torch.equal(full[0][tl], got[0]) and torch.equal(full[1][tl], got[1])


def test_knn_exclude_self_matches_jax():
    qg, _, probe, _, _ = _probe_and_extension("int", exclude_self=True)
    got = refine_knn_reference(qg.points, qg.points, qg.perm, probe, K,
                               exclude_self=True)
    assert_knn_agree("int", got, jax_knn(qg, qg, probe, exclude_self=True))
    valid = np.arange(N_TILES * CHUNK).reshape(N_TILES, CHUNK) < 3800
    own = qg.perm.reshape(N_TILES, CHUNK, 1).numpy()
    assert not np.any((got[1].numpy() == own)[valid])


def _moments_inputs():
    qg, bg, probe, ext, ncand = _probe_and_extension("int")
    _, _, order = tile_bounds(qg, bg, 3800)
    cand = order[:, :10].contiguous()
    dk, ik = refine_knn_reference(qg.points, bg.points, bg.perm, cand, K)
    # The count gate covers every member's chunk: all 10 for most tiles.
    nc = torch.full((N_TILES,), 10, dtype=torch.int32)
    return qg, bg, order, cand, nc, dk[:, :, -1].contiguous(), \
        ik[:, :, -1].contiguous()


def test_moments_stage1_and_tier_match_jax():
    """K4 over a stage-1 prefix, then a seeded tier extending compacted
    tiles past it: the count is exactly k on every row, the sums agree."""
    qg, bg, order, cand, nc, rk, ik = _moments_inputs()
    mom = knn_moments_reference(qg.points, bg.points, bg.perm, cand[:, :6],
                                torch.full_like(nc, 6), rk, ik)
    want = jax_moments(qg, bg, cand[:, :6].contiguous(),
                       torch.full_like(nc, 6), rk, ik)
    assert_moments_agree(mom, want)
    tiles = torch.tensor([3, 12, 0, 7, 9, 1, 14, 5], dtype=torch.int32)
    tl = tiles.long()
    ncm = torch.tensor([4, 0, 2, 4, 4, 1, 3, 4], dtype=torch.int32)
    tcand = order[tl, 6:10].contiguous()
    got = knn_moments_reference(qg.points, bg.points, bg.perm, tcand, ncm,
                                rk[tl].contiguous(), ik[tl].contiguous(),
                                tiles=tiles, init=mom[tl].contiguous())
    cols = (tiles.numpy()[:, None] * CHUNK + np.arange(CHUNK)).reshape(-1)
    want = jax_moments(qg, bg, tcand, ncm, rk[tl].contiguous(),
                       ik[tl].contiguous(), init=mom[tl].contiguous(),
                       q_cols=cols)
    assert_moments_agree(got, want)
    # Tiles extended over all 10 chunks count exactly the k members, and
    # their sums equal a float64 gather of the k-NN ids (integer offsets).
    full = ncm.numpy() == 4
    assert np.all(got[full][..., 0].numpy() == K)
    _, ikk = refine_knn_reference(qg.points, bg.points, bg.perm, cand, K)
    q = qg.points.double().numpy().reshape(-1, CHUNK, 3)
    inv = np.empty(bg.perm.shape[0], np.int64)
    inv[bg.perm.numpy()] = np.arange(bg.perm.shape[0])
    b = bg.points.double().numpy()
    for j, t in enumerate(tl.tolist()):
        rows = np.arange(t * CHUNK, (t + 1) * CHUNK) < 3800
        if not full[j] or not rows.any():
            continue
        off = b[inv[ikk[t].numpy()]] - q[t][:, None, :]  # (256, k, 3)
        x, y, z = off[..., 0], off[..., 1], off[..., 2]
        sums = np.stack([s.sum(1) for s in (
            x, y, z, x * x, y * y, z * z, x * y, x * z, y * z)], 1)
        np.testing.assert_array_equal(got[j, rows, 1:].numpy(), sums[rows])


def test_cpu_dispatch_and_validation():
    """On CPU tensors the wrappers ARE the plain versions and count no
    launch; malformed inputs raise; a buffer that sees fewer than k finite
    candidates ends in (inf, INT_MAX)."""
    qg = _grid("int", 500, 4, pad_to=512)
    _, _, order = tile_bounds(qg, qg, 500)
    cand = order[:, :2].contiguous()
    before = (refine_knn.launches, knn_moments.launches)
    got = refine_knn(qg.points, qg.points, qg.perm, cand, 8, exclude_self=True)
    want = refine_knn_reference(qg.points, qg.points, qg.perm, cand, 8,
                                exclude_self=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    nc = torch.full((2,), 2, dtype=torch.int32)
    boxes = (qg.bbox_lo, qg.bbox_hi)
    m = knn_moments(qg.points, qg.points, qg.perm, cand, nc,
                    got[0][:, :, -1].contiguous(), got[1][:, :, -1].contiguous(),
                    boxes=boxes)
    assert torch.equal(m, knn_moments_reference(
        qg.points, qg.points, qg.perm, cand, nc, got[0][:, :, -1].contiguous(),
        got[1][:, :, -1].contiguous()))
    assert (refine_knn.launches, knn_moments.launches) == before
    with pytest.raises(ValueError):
        refine_knn(qg.points, qg.points, qg.perm, cand.long(), 8)
    with pytest.raises(ValueError):
        refine_knn(qg.points, qg.points, qg.perm, cand, 33)
    with pytest.raises(ValueError):
        refine_knn(qg.points, qg.points, qg.perm, cand, 8,
                   init=(got[0][:, :, :4], got[1][:, :, :4]))
    with pytest.raises(ValueError):
        knn_moments(qg.points, qg.points, qg.perm, cand, None, got[0][:, :, -1],
                    got[1][:, :, -1], boxes=boxes)
    # a self-exclusive k-NN sums its moments from a gather of its k
    # neighbours, as JAX's does: equal counts, sums within its tolerance
    got = knn_pruned_sorted(qg, qg, 500, 8, exclude_self=True,
                            with_moments=True)
    assert_matches(got, jax_knn_sorted(qg, qg, 500, k=8, exclude_self=True,
                                       with_moments=True), 500, k=8)
    # fully gated tiles without a seed keep (inf, INT_MAX) in every slot
    d, i = refine_knn(qg.points, qg.points, qg.perm, cand, 8,
                      ncand=torch.zeros(2, dtype=torch.int32))
    assert torch.all(torch.isinf(d)) and torch.all(i == INT_MAX)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the k-NN kernels have no CPU mode")
    return torch.device("cuda")


def _to(g, dev):
    return type(g)(*(x.to(dev) for x in g))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
def test_cuda_knn_kernel_matches_plain_version(kind, cuda_device):
    """K3 on the card against refine_knn_reference on the same card: bit for
    bit in every mode (probe, gated + seeded, compacted tiles, self, k=8)."""
    qg, bg, probe, ext, ncand = _probe_and_extension(kind)
    qg, bg = _to(qg, cuda_device), _to(bg, cuda_device)
    probe, ext, ncand = (x.to(cuda_device) for x in (probe, ext, ncand))
    seed = refine_knn(qg.points, bg.points, bg.perm, probe, K)
    tiles = torch.tensor([3, 0, 15, 8], dtype=torch.int32, device=cuda_device)
    tl = tiles.long()
    calls = [
        (bg, probe, K, {}),
        (bg, ext, K, dict(ncand=ncand, init=seed)),
        (bg, ext[tl].contiguous(), K, dict(
            tiles=tiles, init=(seed[0][tl].contiguous(),
                               seed[1][tl].contiguous()))),
        (qg, probe, K, dict(exclude_self=True)),
        (bg, probe, 8, {}),
    ]
    for sg, cand, k, kw in calls:
        args = (qg.points, sg.points, sg.perm, cand, k)
        before = refine_knn.launches
        dk, ik = refine_knn(*args, **kw)
        torch.cuda.synchronize()
        assert refine_knn.launches == before + 1
        dr, ir = refine_knn_reference(*args, **kw)
        assert torch.equal(dk.view(torch.int32), dr.view(torch.int32))
        assert torch.equal(ik, ir)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
def test_cuda_moments_kernel_matches_plain_version(kind, cuda_device):
    """K4 on the card against knn_moments_reference on the same card: the
    member count exactly k, the sums within float32 summation-order error."""
    qg, bg, probe, _, _ = _probe_and_extension(kind)
    qg, bg = _to(qg, cuda_device), _to(bg, cuda_device)
    _, _, order = tile_bounds(qg, bg, 3800)
    cand = order[:, :10].contiguous()
    dk, ik = refine_knn(qg.points, bg.points, bg.perm, cand, K)
    rk, rid = dk[:, :, -1].contiguous(), ik[:, :, -1].contiguous()
    nc = torch.full((N_TILES,), 10, dtype=torch.int32, device=cuda_device)
    tiles = torch.tensor([3, 0, 15, 8], dtype=torch.int32, device=cuda_device)
    tl = tiles.long()
    half = torch.full((4,), 5, dtype=torch.int32, device=cuda_device)
    boxes = (bg.bbox_lo, bg.bbox_hi)
    calls = [
        (cand, nc, rk, rid, {}),
        (cand[tl, 5:].contiguous(), half, rk[tl].contiguous(),
         rid[tl].contiguous(), dict(tiles=tiles, init=knn_moments(
             qg.points, bg.points, bg.perm, cand[tl, :5].contiguous(), half,
             rk[tl].contiguous(), rid[tl].contiguous(), tiles=tiles,
             boxes=boxes))),
    ]
    for c, n, r, i, kw in calls:
        args = (qg.points, bg.points, bg.perm, c, n, r, i)
        before = knn_moments.launches
        got = knn_moments(*args, boxes=boxes, **kw)
        torch.cuda.synchronize()
        assert knn_moments.launches == before + 1
        want = knn_moments_reference(*args, **kw)
        assert torch.equal(got[..., 0], want[..., 0])
        assert torch.all(got[..., 0] == K)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-4)
