"""PyTorch port: K4's (the k-NN moment sums') split and skips.

The CUDA K4 (``knn_moments``) walks each tile's live slots in ``splits``
balanced parts (``split_ranges``, the kernel's ``pcc::split_begin``), one
block each, and the leader adds the parts' ten sums in rank order, with
the seed in part 0 only. It skips, exactly, every record that cannot be a
member of a row's k-NN set, (d < rk) | (d == rk & id <= ik): a warp skips a
32-record word whose box every one of its rows is bounded beyond its rk
from, and a block skips a slot whose chunk box (the search grid's
``bbox_lo``/``bbox_hi``) every row of the tile is bounded beyond its rk
from.

On the CPU these tests hold a plain-torch model of the split (the plain
version over the parts, summed in rank order) to the unsplit plain version
on integer clouds full of ties and on float clouds, show that no member
lies in a skipped word or slot, and hold one split case against the JAX
package's Pallas kernel in interpret mode (at the shapes
test_torch_knn_refine.py already compiles). The tests marked ``cuda`` hold
the kernel at stage-1, tier-A and tier-B shapes, at the automatic split and
at ``splits=1``, to the plain version on the card.
"""
import functools

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.grid import CHUNK, bbox_lower_bounds
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds
from open_pcc_metric_tpu_torch.ops.refine import (
    MAX_SPLITS, MOM_CH, _offsets, knn_moments, knn_moments_reference,
    refine_knn, refine_knn_reference, sm_count, split_count, split_ranges)

from test_torch_knn_refine import (
    _moments_inputs, assert_moments_agree, jax_moments)

N_TILES = 8
K = 30
# float32 summation order (chip_smoke.py, csrc/knn_moments.cu): a row of at
# most K members within MOM_RTOL/MOM_ATOL, a row of n > K within rtol
# n * 2**-23 (on the card only, where the orders differ)
MOM_RTOL, MOM_ATOL = 1e-6, 1e-4


def _grid(kind, n, seed, hi, dup=1, pad_to=N_TILES * CHUNK):
    """A cloud of n points in [0, hi)^3, integer or float, each point
    ``dup`` times (exactly tied distances), Morton-sorted on the CPU."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        base = rng.integers(0, hi, (n // dup, 3)).astype(np.float64)
    else:
        base = rng.uniform(0.0, hi, (n // dup, 3))
    pts = np.concatenate([base] * dup)[rng.permutation(n // dup * dup)]
    return Cloud.from_numpy(pts, pad_to=pad_to, device="cpu").get_grid(
        build="device")


@functools.lru_cache(maxsize=None)
def _case(kind, self_search):
    """(q grid, b grid, cand (8, 8): every chunk in lb order, ncand with 0,
    in-range and above-w counts, rk, ik): each row's exact 30th neighbour
    (a self search keeps the point itself, as the estimation does), so
    rows of tiles gated below 8 count fewer members."""
    qg = _grid(kind, 1950, 1, 32)
    bg = qg if self_search else _grid(kind, 1900, 2, 32, dup=2)
    _, _, order = tile_bounds(qg, bg, 1950)
    cand = order.contiguous()
    dk, ik = refine_knn_reference(qg.points, bg.points, bg.perm, cand, K)
    ncand = torch.tensor([0, 8, 5, 20, 1, 7, 3, 8], dtype=torch.int32)
    return (qg, bg, cand, ncand, dk[..., -1].contiguous(),
            ik[..., -1].contiguous())


def _parts(cand, ncand, splits):
    """(cand, ncand) of each split's call: tile t's slots [begin, end) of
    its live ones, left-aligned (later columns gated off)."""
    nt, w = cand.shape
    live = torch.clamp(ncand.long(), 0, w)
    out = []
    for lo, hi in split_ranges(live, splits):
        width = max(1, int((hi - lo).max()))
        idx = torch.clamp(lo[:, None] + torch.arange(width), max=w - 1)
        out.append((cand.gather(1, idx).contiguous(), (hi - lo).int()))
    return out


def split_moments(q, b, perm, cand, ncand, rk, ik, splits, tiles=None,
                  init=None, seed_parts=(0,)):
    """K4's split model: the plain version over each part, the seed in the
    parts ``seed_parts``, the parts' sums added in rank order (the
    leader's order)."""
    total = None
    for s, (sub, n) in enumerate(_parts(cand, ncand, splits)):
        part = knn_moments_reference(q, b, perm, sub, n, rk, ik, tiles,
                                     init if s in seed_parts else None)
        total = part if total is None else total + part
    return total


def _assert_moments_close(got, want):
    assert torch.equal(got[..., 0], want[..., 0])
    torch.testing.assert_close(got, want, rtol=MOM_RTOL, atol=MOM_ATOL)


@pytest.fixture(scope="module", params=["int", "float"])
def cases(request):
    """Per cloud kind: the cross and self cases with their unsplit plain
    results, seeded (on compacted tiles) and not."""
    out = {}
    for self_search in (False, True):
        qg, bg, cand, ncand, rk, ik = _case(request.param, self_search)
        args = (qg.points, bg.points, bg.perm, cand, ncand, rk, ik)
        tiles = torch.tensor([5, 2, 7, 0, 1], dtype=torch.int32)
        tl = tiles.long()
        head = knn_moments_reference(*args[:3], cand[tl, :2].contiguous(),
                                     torch.full((5,), 2, dtype=torch.int32),
                                     rk[tl].contiguous(), ik[tl].contiguous(),
                                     tiles=tiles)
        targs = (*args[:3], cand[tl, 2:].contiguous(),
                 torch.clamp(ncand[tl] - 2, min=0), rk[tl].contiguous(),
                 ik[tl].contiguous())
        tkw = dict(tiles=tiles, init=head)
        out[self_search] = {
            "stage": (args, {}, knn_moments_reference(*args)),
            "tier": (targs, tkw, knn_moments_reference(*targs, **tkw)),
        }
    return request.param, out


@pytest.mark.parametrize("splits", [1, 2, 3, MAX_SPLITS])
def test_moments_split_equals_unsplit(cases, splits):
    """Counts exactly, sums within the float32 summation-order tolerance
    (exact on integer clouds), the seed in part 0 only; ncand 0, in range
    and above w; every point of the cross search cloud twice."""
    kind, by_search = cases
    for name in ("stage", "tier"):
        for self_search in (False, True):
            args, kw, want = by_search[self_search][name]
            got = split_moments(*args, splits, **kw)
            if kind == "int":  # small integer offsets: every sum exact
                assert torch.equal(got, want)
            _assert_moments_close(got, want)
    full = args[4] >= args[3].shape[1]  # tiles whose live range is whole
    assert bool((want[full][..., 0] == K).any())


def test_moments_seed_in_every_part_counts_it_again(cases):
    """The hazard the kernel avoids: a sum is not idempotent, so a seed in
    every part counts its members once a part."""
    _, by_search = cases
    args, kw, want = by_search[False]["tier"]
    got = split_moments(*args, 3, seed_parts=(0, 1, 2), **kw)
    seed = kw["init"][..., 0]
    assert torch.equal(got[..., 0], want[..., 0] + 2 * seed)
    assert bool((seed > 0).any())


@pytest.mark.parametrize("self_search", [False, True])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_skipped_words_and_slots_hold_no_member(kind, self_search):
    """The kernel's skips against the final threshold: a warp's word (32
    records) whose box every row of the warp is bounded beyond its rk from,
    and a slot whose chunk box every row of the tile is bounded beyond its
    rk from, hold no member, in particular no record at d == rk with id <=
    ik. Both skips bite, and ties at rk exist (every search point twice),
    so the check is not empty."""
    qg, bg, cand, ncand, rk, ik = _case(kind, self_search)
    nt, w = cand.shape
    c = cand.long()
    q = qg.points.reshape(nt, CHUNK, 3)
    pts = bg.points.reshape(-1, CHUNK, 3)[c].reshape(nt, 1, w * CHUNK, 3)
    d = _offsets(q, pts)[3]  # (nt, 256, w*256)
    ids = bg.perm.reshape(-1, CHUNK)[c].reshape(nt, 1, -1)
    live = (torch.arange(w)[None, :] < torch.clamp(ncand, 0, w)[:, None]
            ).repeat_interleave(CHUNK, 1)[:, None, :]
    r, i = rk[..., None], ik[..., None]
    member = live & ((d < r) | ((d == r) & (ids <= i)))
    at_rk = live & (d == r) & (ids <= i)
    # word skip: per (tile, warp of 32 rows, word of 32 records)
    words = bg.points.reshape(-1, 32, 3)
    wlb = bbox_lower_bounds(qg.points, qg.points, words.amin(1),
                            words.amax(1))  # (P, words)
    wid = (c[:, :, None] * 8 + torch.arange(8)).reshape(nt, -1)  # (nt, w*8)
    wlb = wlb.reshape(nt, CHUNK, -1).gather(
        2, wid[:, None, :].expand(nt, CHUNK, -1))  # (nt, 256, w*8)
    beyond = (wlb > rk[..., None]).reshape(nt, 8, 32, -1).all(2)
    word_skip = beyond.repeat_interleave(32, 1).repeat_interleave(32, 2)
    # slot skip: per (tile, slot), by the search grid's chunk boxes
    clb = bbox_lower_bounds(qg.points, qg.points, bg.bbox_lo, bg.bbox_hi)
    clb = clb.reshape(nt, CHUNK, -1).gather(2, c[:, None, :].expand(
        nt, CHUNK, w))
    slot_skip = (clb > rk[..., None]).all(1)  # (nt, w)
    slot_skip = slot_skip.repeat_interleave(CHUNK, 1)[:, None, :]
    assert not bool((member & word_skip).any())
    assert not bool((member & slot_skip).any())
    assert bool((at_rk & ~(d < r)).any())  # ties at rk with id <= ik
    assert bool((live & word_skip).any()) and bool((live & slot_skip).any())
    # the members of the words and slots that are walked are all of them
    kept = live & ~word_skip & ~slot_skip
    assert torch.equal(member & kept, member)


def test_split_moments_match_jax():
    """Two split cases against the JAX package's Pallas K4 in interpret
    mode, on the inputs and shapes of test_torch_knn_refine.py's moments
    test: a stage-1 prefix in 3 parts, and a seeded tier on compacted tiles
    in 3 parts with the seed in part 0 only."""
    qg, bg, order, cand, nc, rk, ik = _moments_inputs()
    args = (qg.points, bg.points, bg.perm)
    six = torch.full_like(nc, 6)
    mom = split_moments(*args, cand[:, :6].contiguous(), six, rk, ik, 3)
    assert_moments_agree(mom, jax_moments(qg, bg, cand[:, :6].contiguous(),
                                          six, rk, ik))
    tiles = torch.tensor([3, 12, 0, 7, 9, 1, 14, 5], dtype=torch.int32)
    tl = tiles.long()
    ncm = torch.tensor([4, 0, 2, 4, 4, 1, 3, 4], dtype=torch.int32)
    tcand = order[tl, 6:10].contiguous()
    got = split_moments(*args, tcand, ncm, rk[tl].contiguous(),
                        ik[tl].contiguous(), 3, tiles=tiles,
                        init=mom[tl].contiguous())
    cols = (tiles.numpy()[:, None] * CHUNK + np.arange(CHUNK)).reshape(-1)
    assert_moments_agree(got, jax_moments(
        qg, bg, tcand, ncm, rk[tl].contiguous(), ik[tl].contiguous(),
        init=mom[tl].contiguous(), q_cols=cols))
    assert bool((got[ncm == 4][..., 0] == K).any())


def test_cpu_wrapper_takes_boxes_and_splits():
    """On CPU tensors ``boxes`` and ``splits`` change nothing (the plain
    version runs) and count no launch; a split count outside [1,
    MAX_SPLITS], missing or malformed boxes raise."""
    qg, bg, cand, ncand, rk, ik = _case("int", False)
    args = (qg.points, bg.points, bg.perm, cand, ncand, rk, ik)
    boxes = (bg.bbox_lo, bg.bbox_hi)
    before = knn_moments.launches
    got = knn_moments(*args, boxes=boxes, splits=3)
    assert torch.equal(got, knn_moments_reference(*args))
    assert knn_moments.launches == before
    for bad in (0, MAX_SPLITS + 1):
        with pytest.raises(ValueError):
            knn_moments(*args, boxes=boxes, splits=bad)
    with pytest.raises(ValueError):
        knn_moments(*args, boxes=None)
    with pytest.raises(ValueError):
        knn_moments(*args, boxes=(bg.bbox_lo, bg.bbox_hi[:-1]))
    with pytest.raises(ValueError):
        knn_moments(*args, boxes=(bg.bbox_lo.double(), bg.bbox_hi.double()))


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    return torch.device("cuda")


def _card_calls(dev, shape):
    """One K4 call on the card at a schedule's shape, on a self search of
    220000 integer points (every point twice), with each row's 30th
    neighbour over its 64 lowest-lb chunks: (args, kw, expected split
    count) of stage 1 (every tile, 64 slots), tier A (256 compacted tiles, 64 slots, seeded) or
    tier B (32 compacted tiles, 704 slots, seeded)."""
    rng = np.random.default_rng(31)
    pts = rng.integers(0, 160, (110_000, 3)).astype(np.float64)
    g = Cloud.from_numpy(np.concatenate([pts, pts]), device=dev).get_grid(
        build="device")
    _, _, order = tile_bounds(g, g, 220_000)
    nt = order.shape[0]
    dk, ik = refine_knn(g.points, g.points, g.perm,
                        order[:, :64].contiguous(), K)
    rk, rid = dk[..., -1].contiguous(), ik[..., -1].contiguous()
    base = (g.points, g.points, g.perm)
    boxes = (g.bbox_lo, g.bbox_hi)
    gen = torch.Generator().manual_seed(7)
    if shape == "stage 1":
        ncand = torch.randint(0, 65, (nt,), generator=gen, dtype=torch.int32)
        return ((*base, order[:, :64].contiguous(), ncand.to(dev), rk, rid),
                dict(boxes=boxes), 1)
    n_tiles, lo, hi, splits = ((256, 64, 128, 3) if shape == "tier A"
                               else (32, 128, 832, MAX_SPLITS))
    tiles = torch.randperm(nt, generator=gen)[:n_tiles].to(dev)
    ncand = torch.randint(0, hi - lo + 9, (n_tiles,), generator=gen,
                          dtype=torch.int32).to(dev)
    # integer seeds, as an integer cloud's sums are: every sum stays exact
    init = torch.randint(0, 50, (n_tiles, CHUNK, MOM_CH), generator=gen,
                         dtype=torch.int32).float().to(dev)
    return ((*base, order[tiles, lo:hi].contiguous(), ncand,
             rk[tiles].contiguous(), rid[tiles].contiguous()),
            dict(tiles=tiles.int(), init=init, boxes=boxes), splits)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["stage 1", "tier A", "tier B"])
def test_cuda_moments_match_plain_at_schedule_shapes(shape, cuda_device):
    """K4 at each pass's shape, at the automatic split and at splits=1:
    member counts equal to the plain version's and the sums within the
    tolerance of each row's member count, on every row. A padded query row
    (at 1e9) whose covered slots reach past the 64 that its rk was taken
    over can tie at d == rk with thousands of records, so it counts far
    more than K members and takes the wider bound."""
    args, kw, want_splits = _card_calls(cuda_device, shape)
    nt, w = args[3].shape
    assert split_count(nt, w, sm_count(cuda_device)) == want_splits
    plain_kw = {k: v for k, v in kw.items() if k != "boxes"}
    want = knn_moments_reference(*args, **plain_kw)
    # the members this call sums (the seeds' counts are random integers)
    cnt = want[..., :1] - (kw["init"][..., :1] if "init" in kw else 0)
    rtol = torch.where(cnt <= K, torch.full_like(cnt, MOM_RTOL),
                       cnt * 2.0 ** -23)
    for splits in (None, 1):
        before = knn_moments.launches
        got = knn_moments(*args, splits=splits, **kw)
        torch.cuda.synchronize()
        assert knn_moments.launches == before + 1
        assert torch.equal(got[..., 0], want[..., 0])
        err = (got - want).abs()
        assert bool((err <= MOM_ATOL + rtol * want.abs()).all()), (
            float((err - rtol * want.abs()).max()))
