"""PyTorch port: the Hopper designs of K2b (``count_bbox``) and K1c
(``refine_nn_fused``), modelled in numpy and held to their plain versions.

K2b gives a block ``COUNT_TILES`` query tiles, 4 a warp, stages the chunk
boxes of its chunk range into shared memory a run at a time with the box
of each group of 32 chunks; a warp skips a group whose box's bound is
above all its tiles' limits (no member's bound is below its group's) and
counts for each tile the chunks of the other groups whose bound's bits
are at most the tile's integer limit: for the
threshold th = thr * (1 + count_slack), rounded once in float32, the limit
is (bits(th) & high) | low where th >= 0 and -1 (nothing counts) where th
is negative or NaN. A tile group whose blocks would not fill the card
splits its chunk range over a cluster, and the leader adds the integer
parts. The model does the same and must equal ``count_bbox_reference`` at
the edges: tile counts that are not a multiple of ``COUNT_TILES``, chunk
counts that are not a multiple of the run, one chunk, 2^key_bits chunks,
empty tiles at +-FLT_MAX, and thresholds of +inf, 0, -0, negative, NaN and
exactly at a rounded bound. The kernel inflates the threshold itself, so
``thr * float32(1 + count_slack)`` must be the float ``inflate`` computes.

K1c walks K1b's steps (word skip, one fold a chunk, cluster merge) with two
steps of ``ASYNC_DEPTH`` chunks in K1b's 8-chunk buffer: the next step's
records are copied into one half while the block scans the other. The
model keeps the two halves and must equal ``refine_nn_straight_reference``
for widths below the depth, of one slot, not a multiple of the depth,
under ``exclude_self``, and on K2c's repeated column-0 rows.

The tests marked ``cuda`` hold both kernels to their plain versions on the
card at every split (skipped here); chip_smoke.py does so at the
evaluation paths' shapes.
"""
import re

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.ops import _build
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_boxes
from open_pcc_metric_tpu_torch.ops.refine import (
    ASYNC_DEPTH, INT_MAX, refine_nn_fused, refine_nn_straight,
    refine_nn_straight_reference, split_ranges)
from open_pcc_metric_tpu_torch.ops.select import (
    COUNT_TILES, count_bbox, count_bbox_reference, count_slack, count_split,
    inflate, key_bits, mask_lb, pad128)

from test_torch_k1b_k2a_design import (
    _box_lb, _cloud, _k1b_table, _offset_d)

F32 = np.float32
FLT_MAX = float(np.finfo(F32).max)


def _source(name):
    with open(f"{_build.CSRC_DIR}/{name}") as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


KERNEL_RUN = _constant(_source("count_bbox.cu"), "kRun")
TILES_WARP = _constant(_source("count_bbox.cu"), "kTilesWarp")

# ---------------------------------------------------------------- K2b


def _limits(thr, ncb):
    """Each tile's integer count limit, as the kernel derives it."""
    ncb_pad = pad128(ncb)
    low = (1 << key_bits(ncb_pad)) - 1
    with np.errstate(over="ignore"):  # FLT_MAX rounds up to +inf
        th = thr.astype(F32) * F32(1.0 + count_slack(ncb_pad))
    bits = th.view(np.uint32).astype(np.int64)
    return np.where(th >= 0, ((bits & 0x7FFFFFFF) & ~low) | low, -1)


def _k2b_model(a_lo, a_hi, b_lo, b_hi, thr, splits, run):
    """K2b in numpy: COUNT_TILES tiles a block, TILES_WARP a warp, runs of
    ``run`` staged chunks in groups of 32; a warp skips a group whose box's
    bound is above each of its tiles' limits and counts the chunks of the
    others for all its tiles; the chunk range is cut into ``splits`` parts
    whose counts the leader adds as integers. Returns (counts, (warp,
    group) pairs skipped, (warp, group) pairs bounded)."""
    nta, ncb = a_lo.shape[0], b_lo.shape[0]
    limit = _limits(thr, ncb)
    out = np.full(nta, -1, np.int64)
    skipped = total = 0
    for w0 in range(0, nta, TILES_WARP):  # blocks only group the warps
        t = np.minimum(np.arange(w0, w0 + TILES_WARP), nta - 1)
        count = np.zeros(TILES_WARP, np.int64)
        for s, e in split_ranges(torch.full((1,), ncb), splits):
            for c0 in range(int(s[0]), int(e[0]), run):
                c1 = min(c0 + run, int(e[0]))
                for g0 in range(c0, c1, 32):  # a group's box and its skip
                    c = slice(g0, min(g0 + 32, c1))
                    near = (_box_pair_lb(
                        a_lo[t], a_hi[t], b_lo[c].min(0, keepdims=True),
                        b_hi[c].max(0, keepdims=True))[:, 0].view(np.int32)
                        <= limit[t]).any()
                    skipped += int(not near)
                    total += 1
                    if near:
                        lb = _box_pair_lb(a_lo[t], a_hi[t], b_lo[c], b_hi[c])
                        count += (lb.view(np.int32)
                                  <= limit[t][:, None]).sum(1)
        keep = t >= np.arange(w0, w0 + TILES_WARP)  # tiles past nta unused
        out[t[keep]] = count[keep]
    return out, skipped, total


def _box_pair_lb(a_lo, a_hi, b_lo, b_hi):
    """pcc::bbox_lb of every (tile, chunk) pair: (nta, m) float32."""
    g = np.maximum(np.maximum(a_lo[:, None] - b_hi[None],
                              b_lo[None] - a_hi[:, None]), F32(0))
    with np.errstate(over="ignore"):  # empty tiles' gaps square to +inf
        sq = g * g
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _k2b_case(kind):
    """(a_lo, a_hi, b_lo, b_hi, thr) float32 numpy arrays of one case."""
    rng = np.random.default_rng({"cloud": 71, "one chunk": 72, "2^bits": 73,
                                 "ragged runs": 74}[kind])
    if kind == "cloud":  # 37 tiles, most without a valid point (+-FLT_MAX)
        a, ga = _cloud(rng.integers(0, 60, (3500, 3)).astype(np.float64), 37)
        b, gb = _cloud(rng.integers(0, 60, (3900, 3)).astype(np.float64), 20)
        _, lo, hi = tile_boxes(ga, a.n)
        boxes = [x.numpy() for x in (lo, hi, gb.bbox_lo, gb.bbox_hi)]
    else:
        nta, ncb = {"one chunk": (45, 1), "2^bits": (33, 128),
                    "ragged runs": (70, 2 * KERNEL_RUN + 333)}[kind]
        a_lo = rng.uniform(0, 100, (nta, 3))
        b_lo = rng.uniform(0, 100, (ncb, 3))
        b_lo = b_lo[np.argsort(b_lo[:, 0])]  # in x slabs, as a grid's order
        boxes = [a_lo, a_lo + rng.uniform(0, 5, (nta, 3)), b_lo,
                 b_lo + rng.uniform(0, 5, (ncb, 3))]
        boxes[0][3], boxes[1][3] = FLT_MAX, -FLT_MAX  # an empty tile
    boxes = [np.ascontiguousarray(x, dtype=F32) for x in boxes]
    nta, ncb = boxes[0].shape[0], boxes[2].shape[0]
    masked = mask_lb(torch.from_numpy(_box_pair_lb(*boxes)),
                     pad128(ncb)).numpy()
    # thresholds at a rounded bound (the boundary), between, and the edges
    thr = masked[np.arange(nta), rng.integers(0, ncb, nta)].copy()
    thr[1::3] = np.nextafter(thr[1::3], F32(0))
    edges = [np.inf, 0.0, -0.0, -1.0, np.nan, FLT_MAX, 1e-45, -np.inf]
    thr[-len(edges):] = edges
    return (*boxes, thr.astype(F32))


K2B_CASES = ["cloud", "one chunk", "2^bits", "ragged runs"]


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("kind", K2B_CASES)
def test_k2b_model_equals_plain(kind, splits):
    """Tile groups, staged runs, the group skip and integer split sums
    equal the plain version's counts, at the kernel's run and at a run of
    7 chunks (groups cut short by the run)."""
    case = _k2b_case(kind)
    if kind == "2^bits":
        assert case[2].shape[0] == 1 << key_bits(pad128(case[2].shape[0]))
    want = count_bbox_reference(*map(torch.from_numpy, case)).numpy()
    for run in (KERNEL_RUN, 7):
        got, skipped, total = _k2b_model(*case, splits, run)
        np.testing.assert_array_equal(got, want)
        if kind in ("cloud", "ragged runs") and run == KERNEL_RUN:
            assert 0 < skipped < total  # the skip is taken, not always
    thr = case[4]
    # +inf counts every chunk, +inf bounds too; below 0 or NaN none
    assert (want[thr.view(np.uint32) == 0x7F800000] == case[2].shape[0]).all()
    assert (want[np.isnan(thr) | (thr < 0)] == 0).all()


@pytest.mark.parametrize("bits", range(1, 21))
def test_in_kernel_inflation_equals_inflate(bits):
    """``1 + count_slack`` is exact in float32 for every key width, so the
    kernel's one rounding of thr * factor is the float ``inflate``
    computes (torch's float32 tensor times a Python float)."""
    factor = 1.0 + 2.0 ** (bits - 21)
    assert float(F32(factor)) == factor
    rng = np.random.default_rng(bits)
    tiny = np.finfo(F32).smallest_subnormal
    thr = np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, FLT_MAX, -FLT_MAX,
                  FLT_MAX / factor, tiny, 2 * tiny, np.finfo(F32).tiny,
                  1.0, 3.0, 2.0 ** 24 - 1]),
        rng.uniform(0, 1e6, 64), np.exp(rng.uniform(-80, 80, 64)),
    ]).astype(F32)
    with np.errstate(over="ignore"):
        want = thr * F32(factor)  # one float32 rounding, as __fmul_rn
    got = torch.from_numpy(thr) * factor
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[~np.isnan(
        want)], want.view(np.uint32)[~np.isnan(want)])
    assert np.isnan(got.numpy()[np.isnan(want)]).all()
    if bits >= 7:  # the key widths a padded chunk count can have
        ncb = 2 ** (bits - 1) + 1
        assert key_bits(pad128(ncb)) == bits
        np.testing.assert_array_equal(
            inflate(torch.from_numpy(thr), ncb).numpy().view(np.uint32)[
                ~np.isnan(want)], want.view(np.uint32)[~np.isnan(want)])


def test_k2b_split_rule_and_kernel_constants():
    """count_split fills an H100 twice at the select prologue's shapes and
    never gives a split fewer than 256 chunks; the kernel states the same
    tiles a block."""
    assert count_split(3328, 1920, 132) == 3  # 800k a->b
    assert count_split(8192, 8192, 132) == 2  # 2M self
    assert count_split(70000, 8192, 132) == 1
    assert count_split(5, 1, 132) == 1
    assert count_split(5, 100_000, 132) == 8
    assert count_split(0, 10, 132) == 1
    src = _source("count_bbox.cu")
    assert 8 * TILES_WARP == COUNT_TILES
    assert _constant(src, "kThreads") == 256


# ---------------------------------------------------------------- K1c


def _k1c_model(q_sorted, b_sorted, b_orig, cand, exclude_self, splits,
               depth=ASYNC_DEPTH):
    """K1c's walk in numpy: two halves of ``depth`` staged chunks, the next
    step copied into the other half before this one is scanned; per chunk
    K1b's word skip and fold. Returns (d, id, words skipped, words)."""
    q = q_sorted.numpy().reshape(-1, CHUNK, 3)
    b = b_sorted.numpy().reshape(-1, CHUNK, 3)
    ids = b_orig.numpy().reshape(-1, CHUNK)
    nt, w = cand.shape
    out_d = np.empty((nt, CHUNK), F32)
    out_i = np.empty((nt, CHUNK), np.int64)
    skipped = total = 0
    for t in range(nt):
        parts = []
        for s, e in split_ranges(torch.full((1,), w), splits):
            s, e = int(s[0]), int(e[0])
            halves = [[None] * depth, [None] * depth]  # staged chunk ids

            def copy(s0, half):
                for j in range(min(depth, e - s0)):
                    halves[half][j] = int(cand[t, s0 + j])

            bd = np.full(CHUNK, np.inf, F32)
            bi = np.full(CHUNK, INT_MAX, np.int64)
            if s < e:
                copy(s, 0)
            half = 0
            for s0 in range(s, e, depth):
                if s0 + depth < e:
                    copy(s0 + depth, half ^ 1)  # in flight during the scan
                for j in range(min(depth, e - s0)):
                    c = halves[half][j]
                    assert c == int(cand[t, s0 + j])
                    rec, rid = b[c], ids[c].astype(np.int64)
                    d = _offset_d(q[t], rec)
                    if exclude_self and c == t:
                        d[np.arange(CHUNK), np.arange(CHUNK)] = np.inf
                    words = rec.reshape(8, 32, 3)
                    lb = _box_lb(q[t], words.min(1), words.max(1))
                    skip = (lb.reshape(8, 32, 8) > bd.reshape(8, 32, 1)).all(1)
                    skipped += int(skip.sum())
                    total += skip.size
                    gone = np.repeat(np.repeat(skip, 32, axis=0), 32, axis=1)
                    d = np.where(gone, np.inf, d)
                    i = np.where(gone, INT_MAX, np.broadcast_to(rid, d.shape))
                    md = d.min(1)
                    mi = np.where(d == md[:, None], i, INT_MAX).min(1)
                    better = (md < bd) | ((md == bd) & (mi < bi))
                    bd = np.where(better, md, bd)
                    bi = np.where(better, mi, bi)
                half ^= 1
            parts.append((bd, bi))
        bd, bi = parts[0]
        for pd, pi in parts[1:]:
            better = (pd < bd) | ((pd == bd) & (pi < bi))
            bd, bi = np.where(better, pd, bd), np.where(better, pi, bi)
        out_d[t], out_i[t] = bd, bi
    return out_d, out_i, skipped, total


def _k1c_table(kind, width):
    qg, bg, cand, ex = _k1b_table(kind)
    return qg, bg, cand[:, :width].contiguous(), ex


# (table, slots): below the depth, one slot, not a multiple of the depth
K1C_CASES = [("empty tiles", 7), ("empty tiles", 1), ("exclude_self", 9),
             ("exclude_self", 3), ("tied", 6)]


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("kind,width", K1C_CASES)
def test_k1c_two_half_walk_equals_plain(kind, width, splits):
    """The two-half walk scans every slot once, in order, and changes no
    row: d and id bit for bit against the plain version; words are
    skipped wherever a row has a best to hold them to."""
    qg, bg, cand, ex = _k1c_table(kind, width)
    assert width % ASYNC_DEPTH
    d, i, skipped, total = _k1c_model(qg.points, bg.points, bg.perm, cand,
                                      ex, splits)
    want_d, want_i = refine_nn_straight_reference(qg.points, bg.points,
                                                  bg.perm, cand,
                                                  exclude_self=ex)
    np.testing.assert_array_equal(d.view(np.int32),
                                  want_d.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())
    if kind == "tied" or width == 1:
        assert skipped == 0  # ties, or no best before the only chunk
    elif width > 3:
        assert 0 < skipped < total


def test_k1c_depth_fills_k1b_buffer():
    """Two steps of ASYNC_DEPTH chunks are K1b's kStage positions, so K1c's
    shared memory is K1b's; the header derives the depth from kStage."""
    src = _source("pcc_nn.cuh")
    assert 2 * ASYNC_DEPTH == _constant(src, "kStage")
    assert "constexpr int kAsyncDepth = kStage / 2;" in src


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2b and K1c have no CPU mode")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", K2B_CASES)
def test_cuda_k2b_equals_plain_at_every_split(cuda_device, kind):
    """K2b on the card against its plain version, at the automatic split
    and at every split from 1 to 8: counts equal."""
    case = [torch.from_numpy(x) for x in _k2b_case(kind)]
    want = count_bbox_reference(*case)
    gpu = [x.to(cuda_device) for x in case]
    before = count_bbox.launches
    for splits in (None, *range(1, 9)):
        got = count_bbox(*gpu, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (kind, splits)
    assert count_bbox.launches == before + 9


@pytest.mark.cuda
@pytest.mark.parametrize("kind,width", K1C_CASES)
def test_cuda_k1c_equals_k1b_and_plain(cuda_device, kind, width):
    """K1c on the card at splits 1, 2 and 8 against K1b and the plain
    version: d and id bit for bit."""
    qg, bg, cand, ex = _k1c_table(kind, width)
    want = refine_nn_straight_reference(qg.points, bg.points, bg.perm, cand,
                                        exclude_self=ex)
    args = [x.to(cuda_device) for x in (qg.points, bg.points, bg.perm, cand)]
    k1b = refine_nn_straight(*args, exclude_self=ex)
    for splits in (None, 1, 2, 8):
        got = refine_nn_fused(*args, exclude_self=ex, splits=splits)
        torch.cuda.synchronize()
        for x, y, z in zip(got, want, k1b):
            assert torch.equal(_bits(x.cpu()), _bits(y)), (kind, splits)
            assert torch.equal(_bits(x), _bits(z)), (kind, splits)
