"""PyTorch port: the redesigned adaptive refine (K7) and the adaptive
schedule's seeded tail pass.

K7 (``csrc/adaptive_refine.cu``) splits each row's live slots over a
thread-block cluster merged by the lexicographic (d, id) minimum, as K1
does, and skips a warp's 32-record word when every row is bounded away
from the word's box by more than its best d and that best is below 2^22
(``pcc::nn::kSkipGuard``), where the expanded-norm form's rounding cannot
reorder a skipped record. The schedule (``nn_pruned_adaptive_sorted``)
walks each tail tile's lb order in P3 only beyond the prefix that P1 and P2
refined, seeded with P2's rows.

On the CPU, in pure torch and numpy (no JAX compile), these tests hold:

  * the seeded P3 to the JAX package's from-scratch P3, written out here
    over K7's plain version, bit for bit on valid rows, on clouds and
    budgets that force tail tiles, with and without ``exclude_self``;
  * K7's split model (the plain version over each part, seeded in every
    part, merged by the lexicographic minimum) to the unsplit plain
    version;
  * the guard: with the kernel's roundings emulated in numpy, a record's
    expanded d is never below min(its difference-form d, 2^22), so a row
    whose best is below 2^22 and whose box bound (which never exceeds the
    difference-form d) is above that best can take no record of the box;
  * ``splits=``, validated as ``refine_nn``'s.

The tests marked ``cuda`` hold the kernel at splits 1-8 and the automatic
count to its plain version on the card, on tiles dense with sentinel rows
and coordinates near 1600, where some rows' best sits above the guard.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_mod
from open_pcc_metric_tpu_torch.ops import refine_adaptive as ra
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.nn_pruned import (
    cert_ub, count_under, nn_pruned_adaptive_sorted, stable_top, tile_bounds)
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, MAX_SPLITS, sm_count, split_count)

from test_torch_adaptive import _clouds, _spy
from test_torch_nn_pruned import _grid
from test_torch_refine_split import _parts

GUARD = 2.0 ** 22  # pcc::nn::kSkipGuard
MXU_MAX = 1600  # Cloud.mxu_exact's largest |coordinate|


def _from_scratch(ga, gb, n_a, exclude_self, cap, ft3, p1):
    """The JAX package's adaptive schedule (its nn_pruned.py:102-207), every
    pass through K7's plain version: P3 refines each tail tile from scratch
    over order[:count2]. Returns (d, id, overflow, tail tiles P3 ran)."""
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    cap = min(cap, ncb)
    p1 = min(p1, cap)
    valid_t, lb, order = tile_bounds(ga, gb, n_a)
    qhat = ra.pack_queries(ga.points)
    bhat = ra.pack_candidates(gb.points, gb.perm)
    tids = torch.arange(nta, dtype=torch.int32)

    def refine(cand, ncand, tiles, init=None):
        return ra.adaptive_refine_reference(
            qhat, bhat, cand.contiguous(), ncand.to(torch.int32), tiles,
            init=init, exclude_self=exclude_self)

    d1, i1 = refine(order[:, :p1], torch.full_like(tids, p1), tids)
    count1 = count_under(lb, cert_ub(d1, valid_t))
    if cap > p1:
        ncand2 = torch.clamp(torch.clamp(count1, max=cap) - p1, 0, cap - p1)
        d2, i2 = refine(order[:, p1:cap], ncand2, tids, init=(d1, i1))
    else:
        d2, i2 = d1, i1
    count2 = count_under(lb, cert_ub(d2, valid_t))
    ft = min(ft3, nta)
    is_tail = count2 > cap
    overflow = bool(is_tail.sum() > ft)
    tail = 0
    if ft > 0 and cap < ncb:
        otiles = stable_top(torch.where(is_tail, count2, 0), ft)
        ncand3 = torch.where(is_tail[otiles], count2[otiles], 0)
        d3, i3 = refine(order[otiles], ncand3, otiles.to(torch.int32))
        take = (ncand3 > 0)[:, None]
        d2 = d2.index_copy(0, otiles, torch.where(take, d3, d2[otiles]))
        i2 = i2.index_copy(0, otiles, torch.where(take, i3, i2[otiles]))
        tail = int(take.sum())
    return d2.reshape(-1), i2.reshape(-1), overflow, tail


def _ball(seed, n):
    """A dense ball of duplicate-heavy integer points: many tiles' bounds
    straddle, so small budgets leave tail tiles."""
    rng = np.random.default_rng(seed)
    return _grid(rng.integers(0, 24, (n, 3)).astype(float))


@pytest.mark.parametrize("budget", [(2, 64, 1), (3, 8, 2), (4, 16, 4)],
                         ids=["cap2", "small-ft3", "cap-eq-p1"])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("name", ["ball", "clusters"])
def test_seeded_tail_equals_from_scratch(name, exclude_self, budget,
                                         monkeypatch):
    """P3 over order[cap:count2] seeded with P2's rows gives the rows of the
    from-scratch P3 over order[:count2], bit for bit on valid rows, with
    the same overflow flag; P3 runs on tail tiles in every case, and cap
    == p1 (no P2: P1 alone walked the prefix) is covered."""
    cap, ft3, p1 = budget
    if name == "ball":
        (a, ga), (b, gb) = _ball(11, 3000), _ball(12, 2600)
    else:
        a, ga, b, gb = _clouds("clusters", seed=3)
    if exclude_self:
        b, gb = a, ga
    calls = _spy(monkeypatch, nn_mod, "adaptive_refine")
    got = nn_pruned_adaptive_sorted(ga, gb, a.n, exclude_self=exclude_self,
                                    cap=cap, ft3=ft3, p1=p1)
    want_d, want_i, want_ov, tail = _from_scratch(ga, gb, a.n, exclude_self,
                                                  cap, ft3, p1)
    assert tail > 0  # the budget left tiles for P3
    tail_call = calls[-1]
    assert tail_call[1]["init"] is not None
    assert tail_call[0][2].shape[1] == gb.n_chunks - cap
    assert bool(got[2]) == want_ov
    n = a.n
    assert torch.equal(got[0][:n].view(torch.int32),
                       want_d[:n].view(torch.int32))
    assert torch.equal(got[1][:n], want_i[:n])


def _k7_case(exclude_self, seed=5):
    """K7's arguments for a seeded, gated call over 12 slots of the lb
    order of a ball pair, rows with 0, in-range and above-width counts,
    read through shuffled tile ids."""
    (a, ga), (_, gb) = _ball(seed, 3000), _ball(seed + 1, 2600)
    if exclude_self:
        gb = ga
    _, _, order = tile_bounds(ga, gb, a.n)
    nta = order.shape[0]
    tids = torch.from_numpy(np.random.default_rng(seed).permutation(nta)
                            ).to(torch.int32)
    qhat = ra.pack_queries(ga.points)
    bhat = ra.pack_candidates(gb.points, gb.perm)
    seed_rows = ra.adaptive_refine_reference(
        qhat, bhat, order[tids.long(), :2].contiguous(),
        torch.full((nta,), 2, dtype=torch.int32), tids,
        exclude_self=exclude_self)
    cand = order[tids.long(), 2:14].contiguous()
    ncand = torch.tensor([0, 12, 5, 40, 1, 7, 12, 3, 9, 2, 11, 0],
                         dtype=torch.int32).repeat(nta // 12 + 1)[:nta]
    return (qhat, bhat, cand, ncand, tids), seed_rows, a.n


@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_adaptive_split_model_equals_unsplit(exclude_self, splits):
    """K7's split: the plain version over each of ``splits`` balanced parts
    of a row's live slots, seeded in every part, merged by the
    lexicographic minimum, equals the unsplit plain version bit for bit."""
    args, seed_rows, _ = _k7_case(exclude_self)
    qhat, bhat, cand, ncand, tids = args
    want = ra.adaptive_refine_reference(*args, init=seed_rows,
                                        exclude_self=exclude_self)
    best = None
    for sub, n in _parts(cand, ncand, splits):
        d, i = ra.adaptive_refine_reference(qhat, bhat, sub, n, tids,
                                            init=seed_rows,
                                            exclude_self=exclude_self)
        if best is not None:
            keep = (best[0] < d) | ((best[0] == d) & (best[1] < i))
            d, i = torch.where(keep, best[0], d), torch.where(keep, best[1], i)
        best = (d, i)
    assert torch.equal(best[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(best[1], want[1])


def _expanded_fma(q, b):
    """pcc::expanded over (n, 3) float32 integer points, its fused
    multiply-adds emulated: each step's exact value in float64 (integers
    far below 2^53), rounded once to float32."""
    f32, f64 = np.float32, np.float64

    def sq(p):  # pcc::sq_norm, each float32 step rounded on its own
        return (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]

    d = sq(b) + sq(q)
    for c in range(3):
        d = (d.astype(f64) + b[:, c].astype(f64)
             * (f32(-2.0) * q[:, c]).astype(f64)).astype(f32)
    return d


def _offset(q, b):
    """pcc::offset's d: ((dx*dx + dy*dy) + dz*dz), dx = b - q, float32."""
    dx = b - q
    return (dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1]) + dx[:, 2] * dx[:, 2]


def test_expanded_never_below_guarded_offset():
    """The skip guard's claim on mxu_exact coordinates (|coord| <= 1600):
    expanded d >= min(offset d, 2^22) for every pair, and expanded d ==
    offset d == the exact D below 2^24 - 4 * 1600^2. Far pairs do round
    (so the guard is needed), and they stay above the guard."""
    rng = np.random.default_rng(17)
    n = 400_000
    q = rng.integers(-MXU_MAX, MXU_MAX + 1, (n, 3))
    b = rng.integers(-MXU_MAX, MXU_MAX + 1, (n, 3))
    # the far corners, where the partial sums are largest
    corner = rng.choice([-MXU_MAX, MXU_MAX], (20_000, 3))
    q = np.concatenate([q, corner, corner])
    b = np.concatenate([b, -corner, corner - rng.integers(0, 3, corner.shape)])
    exact = ((b - q) ** 2).sum(1)
    q32, b32 = q.astype(np.float32), b.astype(np.float32)
    xd, od = _expanded_fma(q32, b32), _offset(q32, b32)
    assert bool((xd >= np.minimum(od, np.float32(GUARD))).all())
    low = exact < 2 ** 24 - 4 * MXU_MAX ** 2
    assert bool((xd[low] == exact[low]).all())
    assert bool((od[low] == exact[low]).all())
    assert bool((xd[~low] != exact[~low]).any())
    assert bool((np.abs(xd.astype(np.int64) - exact) <= 3).all())
    assert bool((xd[~low] > GUARD).all())


def test_adaptive_refine_takes_splits():
    """On CPU tensors ``splits`` changes nothing (the plain version runs)
    and counts no launch; a count outside [1, MAX_SPLITS] raises, as
    ``refine_nn``'s does."""
    args, seed_rows, _ = _k7_case(False)
    before = ra.adaptive_refine.launches
    want = ra.adaptive_refine_reference(*args, init=seed_rows)
    for splits in (1, 3, MAX_SPLITS, None):
        got = ra.adaptive_refine(*args, init=seed_rows, splits=splits)
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
    assert ra.adaptive_refine.launches == before
    for bad in (0, -1, MAX_SPLITS + 1):
        with pytest.raises(ValueError):
            ra.adaptive_refine(*args, splits=bad)


def test_split_count_at_the_adaptive_passes():
    """split_count at the adaptive schedule's 800k shapes on an H100 (132
    SMs): the probe and the extension (3328 rows) run one block a row,
    P3's 64 tail rows 8."""
    assert split_count(3328, 8, 132) == 1
    assert split_count(3328, 56, 132) == 1
    assert split_count(64, 1920 - 64, 132) == MAX_SPLITS


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    return torch.device("cuda")


def _far_pair(dev, exclude_self):
    """Integer clouds within |coord| <= 1600 padded with whole tiles of
    sentinel rows: a dense cluster in one corner, a few points in a central
    box and six lone points at other corners; the search cloud is the same
    (self) or a dense cluster in the opposite corner with its own points in
    the central box. Some rows' nearest
    point is then more than 2048 units away (d above 2^22), others close."""
    rng = np.random.default_rng(31)
    lone = np.array([[1600, 1600, -1600], [1600, -1600, 1600],
                     [-1600, 1600, 1600], [1600, 1600, 1600],
                     [-1600, -1600, 1600], [1600, -1600, -1600]])

    def cloud(*parts):
        pts = np.concatenate(parts).astype(np.float64)
        return Cloud.from_numpy(pts, pad_to=24 * CHUNK, device=dev)

    a = cloud(np.clip([-1540] * 3 + rng.integers(-60, 61, (3300, 3)),
                      -MXU_MAX, MXU_MAX),
              rng.integers(-300, 301, (200, 3)), lone)
    b = a if exclude_self else cloud(
        np.clip([1540] * 3 + rng.integers(-60, 61, (2700, 3)), -MXU_MAX,
                MXU_MAX), rng.integers(-300, 301, (300, 3)))
    assert a.mxu_exact() and b.mxu_exact()
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
def test_cuda_adaptive_splits_match_plain(exclude_self, cuda_device):
    """K7 at splits 1-8 and the automatic count, seeded and unseeded, over
    every chunk of the lb order (sentinel chunks included), with rows above
    and below the skip guard: bit for bit equal to the plain version on
    valid rows."""
    a, b = _far_pair(cuda_device, exclude_self)
    ga, gb = a.get_grid(), b.get_grid()
    _, _, order = tile_bounds(ga, gb, a.n)
    nta, ncb = order.shape
    tids = torch.arange(nta, dtype=torch.int32, device=cuda_device)
    qhat = ra.pack_queries(ga.points)
    bhat = ra.pack_candidates(gb.points, gb.perm)
    full = torch.full((nta,), ncb, dtype=torch.int32, device=cuda_device)
    ncand = torch.remainder(tids * 7, ncb + 3).to(torch.int32)
    seed_rows = ra.adaptive_refine_reference(
        qhat, bhat, order[:, :1].contiguous(), torch.ones_like(tids), tids,
        exclude_self=exclude_self)
    valid = (tids.long()[:, None] * CHUNK
             + torch.arange(CHUNK, device=cuda_device)) < a.n
    cases = {"seeded, gated": (order[:, 1:], ncand, dict(init=seed_rows)),
             "every chunk": (order, full, {})}
    for name, (cand, n, kw) in cases.items():
        args = (qhat, bhat, cand.contiguous(), n, tids)
        want = ra.adaptive_refine_reference(*args, exclude_self=exclude_self,
                                            **kw)
        if name == "every chunk":
            above = want[0][valid] >= GUARD
            assert bool(above.any()) and bool((~above).any())
        for splits in (*range(1, MAX_SPLITS + 1), None):
            before = ra.adaptive_refine.launches
            got = ra.adaptive_refine(*args, exclude_self=exclude_self,
                                     splits=splits, **kw)
            torch.cuda.synchronize()
            assert ra.adaptive_refine.launches == before + 1
            bad = ((got[0] != want[0]) | (got[1] != want[1])) & valid
            assert int(bad.sum()) == 0, (name, splits, int(bad.sum()))


@pytest.mark.cuda
def test_cuda_seeded_tail_matches_cpu(cuda_device):
    """The adaptive schedule with a tail on the card (seeded P3 through the
    kernel, split) against the CPU's: equal valid rows and overflow."""
    (a, ga), (_, gb) = _ball(11, 3000), _ball(12, 2600)
    kw = dict(cap=2, ft3=64, p1=1)
    want = nn_pruned_adaptive_sorted(ga, gb, a.n, **kw)
    to = (lambda g: type(g)(*(x.to(cuda_device) for x in g)))
    got = nn_pruned_adaptive_sorted(to(ga), to(gb), a.n, **kw)
    assert bool(got[2]) == bool(want[2])
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x[: a.n].cpu().view(torch.int32),
                           y[: a.n].view(torch.int32))
    assert INT_MAX not in got[1][: a.n].cpu().tolist()
