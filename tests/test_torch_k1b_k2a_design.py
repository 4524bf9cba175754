"""PyTorch port: the Hopper designs of K1b (``refine_nn_straight``) and K2a
(``select_bbox``), modelled in numpy and held to their plain versions.

K1b walks a tile's candidate chunks with K1's pieces (``csrc/pcc_nn.cuh``):
per chunk, a warp skips a 32-record word when every one of its 32 rows is
bounded away from the word's box (``pcc::point_box_lb``) by more than its
best d so far, folds the chunk's lexicographic (d, id) minimum into its
running best, and a tile split over a cluster merges the parts' minima.
The model does the same in float32 numpy, one rounding a step, and must
equal ``refine_nn_straight_reference`` bit for bit on tables where every
distance ties, on K2c's repeated column-0 rows (query tiles with no valid
point) and under ``exclude_self``.

K2a computes each packed key once, runs 8-bit radix passes from bit 30
until the keys at or below the bin of the cap-th key (the survivors)
number at most ``survivor_room(ncb, cap)``, then writes the survivors'
first ``cap`` in order: ranked by counting when at most 256, else sorted.
The model does the same over the plain version's keys and must equal
``select_bbox_reference`` on rows whose bounds are all 0 (the keys are the
columns), all +inf (empty tiles), all in one first-pass bin, at cap 1 and
cap = ncb, and at widths that are not powers of two. The branch between
this design and the first (bounds recomputed in every pass) is chosen from
ncb alone, at ``SHARED_MAX_CHUNKS``, which the kernel source states too.

The tests marked ``cuda`` hold the kernels to their plain versions on the
same cases on the card (skipped here); chip_smoke.py does so at the
evaluation paths' shapes.
"""
import re

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import _build
from open_pcc_metric_tpu_torch.ops.grid import CHUNK, bbox_lower_bounds
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds, tile_boxes
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, refine_nn_straight, refine_nn_straight_reference,
    select_candidates_reference, split_ranges)
from open_pcc_metric_tpu_torch.ops.select import (
    MIN_ROOM, SHARED_MAX_CHUNKS, _keys, select_bbox, select_bbox_reference,
    shared_bytes, survivor_room)

F32 = np.float32

# ---------------------------------------------------------------- K1b


def _box_lb(q, lo, hi):
    """pcc::point_box_lb of rows q (n, 3) to boxes (lo, hi) (m, 3): (n, m),
    float32, each step rounded: max(q - hi, lo - q, 0)^2 summed x, y, z."""
    g = np.maximum(np.maximum(q[:, None] - hi[None], lo[None] - q[:, None]),
                   F32(0))
    sq = g * g
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _offset_d(q, r):
    """pcc::offset's d of rows q (n, 3) to records r (m, 3): (n, m)."""
    dx = r[None] - q[:, None]
    sq = dx * dx
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _k1b_model(q_sorted, b_sorted, b_orig, cand, exclude_self, splits):
    """K1b's walk in numpy: (d, id, words skipped, words in all)."""
    q = q_sorted.numpy().reshape(-1, CHUNK, 3)
    b = b_sorted.numpy().reshape(-1, CHUNK, 3)
    ids = b_orig.numpy().reshape(-1, CHUNK)
    nt, w = cand.shape
    out_d = np.empty((nt, CHUNK), F32)
    out_i = np.empty((nt, CHUNK), np.int64)
    skipped = total = 0
    live = torch.full((nt,), w)
    for t in range(nt):
        parts = []
        for s, e in split_ranges(live[t:t + 1], splits):
            bd = np.full(CHUNK, np.inf, F32)
            bi = np.full(CHUNK, INT_MAX, np.int64)
            for slot in range(int(s[0]), int(e[0])):
                c = int(cand[t, slot])
                rec, rid = b[c], ids[c].astype(np.int64)
                d = _offset_d(q[t], rec)
                if exclude_self and c == t:
                    d[np.arange(CHUNK), np.arange(CHUNK)] = np.inf
                words = rec.reshape(8, 32, 3)
                lb = _box_lb(q[t], words.min(1), words.max(1))  # (256, 8)
                # warp v skips word u iff all its rows have lb > best
                skip = (lb.reshape(8, 32, 8) > bd.reshape(8, 32, 1)).all(1)
                skipped += int(skip.sum())
                total += skip.size
                gone = np.repeat(np.repeat(skip, 32, axis=0), 32, axis=1)
                d = np.where(gone, np.inf, d)
                i = np.where(gone, INT_MAX, np.broadcast_to(rid, d.shape))
                md = d.min(1)
                mi = np.where(d == md[:, None], i, INT_MAX).min(1)
                better = (md < bd) | ((md == bd) & (mi < bi))
                bd, bi = np.where(better, md, bd), np.where(better, mi, bi)
            parts.append((bd, bi))
        bd, bi = parts[0]
        for pd, pi in parts[1:]:  # the leader's lexicographic merge
            better = (pd < bd) | ((pd == bd) & (pi < bi))
            bd, bi = np.where(better, pd, bd), np.where(better, pi, bi)
        out_d[t], out_i[t] = bd, bi
    return out_d, out_i, skipped, total


def _cloud(pts, tiles):
    c = Cloud.from_numpy(pts, pad_to=tiles * CHUNK, device="cpu")
    return c, c.get_grid(build="device")


def _k1b_table(kind):
    """(query grid, search grid, cand, exclude_self) of one hard table."""
    rng = np.random.default_rng({"tied": 41, "empty tiles": 42,
                                 "exclude_self": 43}[kind])
    if kind == "tied":
        # every candidate the same point: each row's distances all tie,
        # so the lowest original id wins (and no word can be skipped)
        a, ga = _cloud(rng.integers(0, 40, (2000, 3)).astype(np.float64), 8)
        b, gb = _cloud(np.full((8 * CHUNK, 3), 17.0), 8)  # no padding
        cand = torch.from_numpy(rng.integers(0, 8, (8, 6))).to(torch.int32)
        return ga, gb, cand, False
    if kind == "empty tiles":
        # the fixed schedule's table: K2c over the bound matrix, which
        # repeats column 0 on the rows of the 4 tiles with no valid query
        a, ga = _cloud(rng.integers(0, 48, (2000, 3)).astype(np.float64), 12)
        b, gb = _cloud(rng.integers(0, 48, (2500, 3)).astype(np.float64), 10)
        valid_t, lo, hi = tile_boxes(ga, a.n)
        lb = bbox_lower_bounds(lo, hi, gb.bbox_lo, gb.bbox_hi)
        cand = select_candidates_reference(lb, 7)
        assert (cand[~valid_t.any(1)] == 0).all()
        return ga, gb, cand, False
    a, ga = _cloud(rng.integers(0, 48, (2800, 3)).astype(np.float64), 11)
    return ga, ga, tile_bounds(ga, ga, a.n)[2][:, :9].contiguous(), True


K1B_CASES = ["tied", "empty tiles", "exclude_self"]


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kind", K1B_CASES)
def test_k1b_fold_equals_plain(kind, splits):
    """The word-skipping walk and the split merge change no row: d and id
    bit for bit against the plain version. On the tied table no word is
    skipped (a tie must be scanned for its id); on the others some are."""
    qg, bg, cand, ex = _k1b_table(kind)
    d, i, skipped, total = _k1b_model(qg.points, bg.points, bg.perm, cand,
                                      ex, splits)
    want_d, want_i = refine_nn_straight_reference(qg.points, bg.points,
                                                  bg.perm, cand,
                                                  exclude_self=ex)
    np.testing.assert_array_equal(d.view(np.int32),
                                  want_d.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())
    if kind == "tied":
        assert skipped == 0
        low = bg.perm.reshape(-1, CHUNK).amin(1)[cand.long()].amin(1)
        assert (i == low.numpy()[:, None]).all()  # the lowest id visited
    else:
        assert 0 < skipped < total


# ---------------------------------------------------------------- K2a


def _k2a_model(keys, cap, ncb):
    """K2a's survivor select of one row of unique packed keys (uint32):
    (the cap smallest keys ascending, passes, survivors)."""
    room = survivor_room(ncb, cap)
    prefix, taken, rank, shift, fixed = 0, 0, cap, 23, 31
    passes = 0
    while True:
        passes += 1
        match = (keys >> fixed) == (prefix >> fixed)
        hist = np.bincount((keys[match] >> shift) & 0xFF, minlength=256)
        incl = np.cumsum(hist)
        b = int(np.searchsorted(incl, rank))  # first bin reaching rank
        below, inbin = int(incl[b] - hist[b]), int(hist[b])
        top = prefix | (b << shift)
        if taken + below + inbin <= room or shift == 0:
            bound = top | ((1 << shift) - 1)
            break
        prefix, taken, rank = top, taken + below, rank - below
        fixed, shift = shift, max(shift - 8, 0)
    surv = keys[keys <= bound]
    assert len(surv) == taken + below + inbin <= room
    out = np.empty(cap, np.uint32)
    if len(surv) <= 256:  # ranked by counting
        r = (surv[None, :] < surv[:, None]).sum(1)
        out[r[r < cap]] = surv[r < cap]
    else:  # the bitonic sort's result
        out[:] = np.sort(surv)[:cap]
    return out, passes, len(surv)


def _k2a_run(boxes, cap):
    """The model over every row: (cand, lb_sel, passes a row, survivors a
    row), as the kernel writes them."""
    ncb = boxes[2].shape[0]
    keys, low = _keys(*boxes)
    keys = keys.numpy().view(np.uint32)
    rows = [_k2a_model(k, cap, ncb) for k in keys]
    sel = np.stack([r[0] for r in rows])
    cand = np.minimum(sel & np.uint32(low), ncb - 1).astype(np.int32)
    lb_sel = (sel & np.uint32(~low & 0xFFFFFFFF)).view(np.float32)
    return (cand, lb_sel, np.array([r[1] for r in rows]),
            np.array([r[2] for r in rows]))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _k2a_boxes(kind):
    """(a_lo, a_hi, b_lo, b_hi) float32 tensors of one hard case."""
    rng = np.random.default_rng({"zero": 51, "one bin": 52, "cloud": 53,
                                 "empty": 54}[kind])
    if kind == "cloud":  # a cloud's tiles against 13 chunks (not 2^k)
        a, ga = _cloud(rng.integers(0, 40, (2600, 3)).astype(np.float64), 12)
        b, gb = _cloud(rng.integers(0, 40, (3300, 3)).astype(np.float64), 13)
        _, lo, hi = tile_boxes(ga, a.n)  # two tiles without a valid point
        return lo, hi, gb.bbox_lo, gb.bbox_hi
    nta, ncb = 6, 600
    a_lo = rng.uniform(0, 10, (nta, 3))
    a_hi = a_lo + rng.uniform(1, 5, (nta, 3))
    if kind == "zero":  # every chunk box overlaps every tile: bound 0
        b_lo = np.full((ncb, 3), -1.0) - rng.uniform(0, 3, (ncb, 3))
        b_hi = np.full((ncb, 3), 20.0) + rng.uniform(0, 3, (ncb, 3))
    elif kind == "one bin":  # every bound in [1, 2): one exponent
        b_lo = np.repeat(a_hi.max(0, keepdims=True), ncb, 0)
        b_lo[:, 0] += rng.uniform(1.0, 1.4, ncb)
        b_lo[:, 1:] = 0.0
        b_hi = b_lo + 0.5
        b_hi[:, 1:] = 30.0
        a_lo[:, 0] = a_hi[:, 0].max() - 1  # one x gap per chunk for all
        a_hi[:, 0] = a_hi[:, 0].max()
    else:  # "empty": tiles spanning +max to -max, every bound +inf
        big = np.finfo(np.float32).max
        a_lo, a_hi = np.full((nta, 3), big), np.full((nta, 3), -big)
        b_lo = rng.uniform(0, 10, (ncb, 3))
        b_hi = b_lo + 1.0
    return tuple(_t(x) for x in (a_lo, a_hi, b_lo, b_hi))


K2A_CASES = [("zero", 1), ("zero", 32), ("zero", 260), ("zero", 600),
             ("one bin", 32), ("one bin", 200), ("empty", 5), ("cloud", 1),
             ("cloud", 4), ("cloud", 13)]


@pytest.mark.parametrize("kind,cap", K2A_CASES)
def test_k2a_selection_equals_plain(kind, cap):
    """The survivor select equals the plain version bit for bit, cand and
    lb_sel; the hard rows take the passes the design says they do."""
    boxes = _k2a_boxes(kind)
    cand, lb_sel, passes, surv = _k2a_run(boxes, cap)
    want_c, want_l = select_bbox_reference(*boxes, cap)
    np.testing.assert_array_equal(cand, want_c.numpy())
    np.testing.assert_array_equal(lb_sel.view(np.int32),
                                  want_l.numpy().view(np.int32))
    ncb = boxes[2].shape[0]
    assert (surv <= survivor_room(ncb, cap)).all()
    if kind == "zero" and cap < ncb:
        # keys are the columns: bits 30..15 are 0, bits 14..7 split them
        assert (passes == 3).all()
        np.testing.assert_array_equal(cand, np.arange(cap)[None].repeat(6, 0))
    if kind == "one bin" and cap < ncb:
        assert (passes >= 2).all()  # the first pass's bin holds every key
    if kind == "empty":
        assert (passes == 3).all()
        assert np.isinf(lb_sel).all()


def test_k2a_cap_one_and_bitonic_rows():
    """cap 1 stops after the first pass on a cloud's rows; a cap whose
    survivors exceed 256 takes the sort (the model's second branch)."""
    boxes = _k2a_boxes("cloud")
    _, _, passes, surv = _k2a_run(boxes, 1)
    valid = np.isfinite(select_bbox_reference(*boxes, 1)[1].numpy()[:, 0])
    assert (passes[valid] == 1).all()
    boxes = _k2a_boxes("zero")
    cand, _, _, surv = _k2a_run(boxes, 260)
    assert (surv > 256).all()
    want = select_bbox_reference(*boxes, 260)[0].numpy()
    np.testing.assert_array_equal(cand, want)


def test_k2a_branch_from_ncb_alone():
    """The shared-key design serves rows of at most SHARED_MAX_CHUNKS
    chunks at every cap, within one block's opt-in shared memory beside
    the kernel's static scratch; wider rows take the first design whatever
    the cap. The kernel source states the same numbers."""
    limit = 232448 - 2 * 256 * 4 - 64
    for cap in (1, 32, 1024, SHARED_MAX_CHUNKS):
        assert 0 < shared_bytes(SHARED_MAX_CHUNKS, cap) <= limit
        assert shared_bytes(SHARED_MAX_CHUNKS + 1, cap) == 0
    assert shared_bytes(1920, 32) == 4 * (1920 + MIN_ROOM)
    assert shared_bytes(8192, 1024) == 4 * (8192 + 2048)
    assert survivor_room(100, 100) == 100
    with open(f"{_build.CSRC_DIR}/select_bbox.cu") as f:
        src = f.read()
    assert int(re.search(r"kSharedMaxChunks = (\d+);", src)[1]
               ) == SHARED_MAX_CHUNKS
    assert int(re.search(r"kMinRoom = (\d+);", src)[1]) == MIN_ROOM


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1b and K2a have no CPU mode")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", K1B_CASES)
def test_cuda_k1b_equals_plain(cuda_device, kind):
    """K1b on the card against its plain version at one block a tile and
    split over clusters of 3 and 8 blocks: d and id bit for bit."""
    qg, bg, cand, ex = _k1b_table(kind)
    want = refine_nn_straight_reference(qg.points, bg.points, bg.perm, cand,
                                        exclude_self=ex)
    args = [x.to(cuda_device) for x in (qg.points, bg.points, bg.perm, cand)]
    for splits in (None, 1, 3, 8):
        got = refine_nn_straight(*args, exclude_self=ex, splits=splits)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(_bits(x.cpu()), _bits(y)), (kind, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cap", K2A_CASES)
def test_cuda_k2a_equals_plain(cuda_device, kind, cap):
    boxes = _k2a_boxes(kind)
    want = select_bbox_reference(*boxes, cap)
    got = select_bbox(*[x.to(cuda_device) for x in boxes], cap)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(_bits(x.cpu()), _bits(y))


@pytest.mark.cuda
def test_cuda_k2a_wide_rows_take_the_first_design(cuda_device):
    """Rows above SHARED_MAX_CHUNKS chunks (random boxes from a seed) take
    the recompute branch, bit-identical to the plain version at cap 32 and
    1024; the occupancy query reports no dynamic shared memory there."""
    from open_pcc_metric_tpu_torch.ops.select import occupancy

    rng = np.random.default_rng(61)
    ncb = SHARED_MAX_CHUNKS + 1000
    b_lo = rng.uniform(0, 3000, (ncb, 3))
    boxes = [_t(x) for x in (rng.uniform(0, 3000, (8, 3)), None, b_lo,
                             b_lo + rng.uniform(0, 20, (ncb, 3)))
             if x is not None]
    boxes.insert(1, boxes[0] + 15)
    for cap in (32, 1024):
        want = select_bbox_reference(*boxes, cap)
        got = select_bbox(*[x.to(cuda_device) for x in boxes], cap)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(_bits(x.cpu()), _bits(y))
        assert occupancy(ncb, cap)[2] == 0
    assert occupancy(1920, 32)[2] == shared_bytes(1920, 32)
