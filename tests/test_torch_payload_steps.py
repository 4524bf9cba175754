"""PyTorch port: the redesigned payload refine (K6).

K6 (``csrc/refine_nn_payload.cu``) now walks a tile's slots in K1's steps
(``csrc/pcc_nn.cuh``): each chunk's lexicographic (d, id) minimum and its
column within the chunk are folded into the running best once, the winner's
sorted row kept as chunk * 256 + column, and a warp skips a word of 32
staged records whose box every row is bounded away from by more than its
best d. The payload is then one row of ``pay_sorted`` at that sorted row.

On the CPU these tests hold that fold (written out here over single
slots) to the plain version, and the plain version's contract on the
cases the kernel must keep: ties at equal d go to the lowest id,
``exclude_self`` drops the query's own column, an empty candidate row
gives (inf, INT32_MAX) and a zero payload, and the payload is a gather of
the original-order rows at the id. The tests marked ``cuda`` hold the
kernel to the plain version on the card on the same cases.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, PAYLOAD_F, refine_nn_payload, refine_nn_payload_reference)


def _tied_pair(dev, exclude_self, seed=41):
    """Integer clouds whose points all appear twice (every distance tied at
    least once, across chunks too), padded with sentinel rows, with their
    sorted and original-order payload rows."""
    rng = np.random.default_rng(seed)

    def cloud(n):
        base = rng.integers(0, 30, (n // 2, 3)).astype(np.float64)
        pts = np.concatenate([base, base])[rng.permutation(n // 2 * 2)]
        nrm = rng.normal(size=pts.shape)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        return Cloud.from_numpy(pts, colors=rng.uniform(0, 1, pts.shape),
                                normals=nrm, pad_to=16 * CHUNK, device=dev)

    a = cloud(3600)
    b = a if exclude_self else cloud(3000)
    ga, gb = a.get_grid(), b.get_grid()
    pay_o = fused_mod._pack_payload(b.points, b.colors, b.normals)
    _, _, order = tile_bounds(ga, gb, a.n)
    return a, ga, gb, pay_o[gb.perm.long()].contiguous(), pay_o, order


def _fold_model(q, b, perm, pay_sorted, cand, exclude_self):
    """K6's fold: for each slot in order, the plain version over that one
    chunk gives the chunk's (d, id) minimum, and the chunk's sorted row
    enters the running best only when it is lexicographically below it."""
    nt, w = cand.shape
    best_d = torch.full((nt, CHUNK), torch.inf)
    best_i = torch.full((nt, CHUNK), INT_MAX, dtype=torch.int32)
    best_p = torch.zeros((nt, CHUNK, PAYLOAD_F))
    for s in range(w):
        d, i, p = refine_nn_payload_reference(q, b, perm, pay_sorted,
                                              cand[:, s:s + 1].contiguous(),
                                              exclude_self)
        better = (d < best_d) | ((d == best_d) & (i < best_i))
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, i, best_i)
        best_p = torch.where(better[..., None], p.reshape(nt, CHUNK, -1),
                             best_p)
    return best_d, best_i, best_p.reshape(nt * CHUNK, PAYLOAD_F)


def _assert_same(got, want):
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("exclude_self", [False, True])
def test_chunk_fold_equals_plain(exclude_self):
    """The per-chunk (d, id, column) minimum folded once a chunk into the
    running best equals the plain version over all slots: d, id and the
    payload, bit for bit, on every row (sentinel rows included)."""
    a, ga, gb, pay_s, _, order = _tied_pair("cpu", exclude_self)
    args = (ga.points, gb.points, gb.perm, pay_s, order[:, :6].contiguous())
    _assert_same(_fold_model(*args, exclude_self),
                 refine_nn_payload_reference(*args, exclude_self))


@pytest.mark.parametrize("exclude_self", [False, True])
def test_payload_contract_on_ties(exclude_self):
    """On a cloud of doubled points: the lowest of tied original ids wins
    (a float64 brute force over the same candidates agrees), the own
    column is never taken under ``exclude_self``, and the payload is the
    original-order row at the id."""
    a, ga, gb, pay_s, pay_o, order = _tied_pair("cpu", exclude_self)
    cand = order[:, :4].contiguous()
    d, i, p = refine_nn_payload_reference(ga.points, gb.points, gb.perm,
                                          pay_s, cand, exclude_self)
    n = a.n
    d, i, p = d.reshape(-1)[:n], i.reshape(-1)[:n], p[:n]
    assert torch.equal(p, pay_o[i.long()])
    # float64 brute force over each tile's candidate columns
    q = ga.points.double().reshape(-1, CHUNK, 3)
    cols = (cand.long()[:, :, None] * CHUNK + torch.arange(CHUNK)).reshape(
        cand.shape[0], -1)
    pts = gb.points.double()[cols]  # (nt, 4 * 256, 3)
    dd = ((q[:, :, None, :] - pts[:, None]) ** 2).sum(-1)
    if exclude_self:
        own = cols[:, None, :] == (torch.arange(q.shape[0])[:, None] * CHUNK
                                   + torch.arange(CHUNK))[:, :, None]
        dd = torch.where(own, torch.inf, dd)
        assert bool((i != ga.perm[:n]).all())
    ids = gb.perm.long()[cols][:, None, :].expand(dd.shape)
    dmin = dd.amin(2, keepdim=True)
    want_i = torch.where(dd == dmin, ids, INT_MAX).amin(2).reshape(-1)[:n]
    assert torch.equal(i.long(), want_i)
    assert torch.equal(d.double(), dmin.reshape(-1)[:n])
    # the doubled points tie many rows' minima within the candidates
    assert int(((dd == dmin).sum(2).reshape(-1)[:n] >= 2).sum()) > n // 8


def test_empty_rows_get_zero_payload():
    """A call with no slots: every row (inf, INT32_MAX) with a zero
    payload."""
    _, ga, gb, pay_s, _, order = _tied_pair("cpu", False)
    d, i, p = refine_nn_payload_reference(ga.points, gb.points, gb.perm,
                                          pay_s, order[:, :0].contiguous())
    assert bool(torch.isinf(d).all()) and bool((i == INT_MAX).all())
    assert not bool(p.any())


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
def test_cuda_payload_steps_match_plain(exclude_self):
    """K6 on the card against its plain version on doubled points (ties),
    with and without ``exclude_self``, at widths that leave a partial
    8-chunk step (1, 6, 13 slots) and with no slot at all: d, id and
    payload bit for bit on every row, the payload the gather at the id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    a, ga, gb, pay_s, pay_o, order = _tied_pair(torch.device("cuda"),
                                                exclude_self)
    for w in (0, 1, 6, 13):
        args = (ga.points, gb.points, gb.perm, pay_s,
                order[:, :w].contiguous())
        before = refine_nn_payload.launches
        got = refine_nn_payload(*args, exclude_self=exclude_self)
        torch.cuda.synchronize()
        assert refine_nn_payload.launches == before + 1
        _assert_same(got, refine_nn_payload_reference(
            *args, exclude_self=exclude_self))
        ids = got[1].reshape(-1)[: a.n]
        if w:
            assert torch.equal(got[2][: a.n], pay_o[ids.long()])
        else:
            assert not bool(got[2].any())
