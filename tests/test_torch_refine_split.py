"""PyTorch port: K1's and K3's split of a tile's slot range over blocks.

The CUDA K1 (``refine_nn``) and K3 (``refine_knn``) walk each tile's live
slots in ``splits`` balanced parts (``split_ranges``, the kernels'
``pcc::split_begin``), one block each, and merge the parts' results: K1 by
the lexicographic (d, id) minimum, with the seed in every part; K3 by the
lexicographic k-best of the parts' k-lists, with the seed in part 0 only.
K3 also drops, before inserting, every candidate that cannot be a member
of the final k-set: above the k-th smallest of the two smallest
distances of each of 32 strided groups over a part's live chunks, or
above the seed's k-th pair. Both kernels skip a word of 32 staged records
when every row of the warp is bounded away from the word's box.

On the CPU these tests hold a plain-torch model of that split, merge and
threshold (the plain versions over the parts' sub-ranges) to the unsplit
plain version, bit for bit, on integer clouds full of ties, and hold one
split case of each against the JAX package's Pallas kernels in interpret
mode. The tests marked ``cuda`` hold the kernels themselves at tier-B
shapes, for several split counts, to the plain versions on the card.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.grid import CHUNK, bbox_lower_bounds
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, MAX_SPLITS, _extract_k, _offsets, _self_mask, refine_knn,
    refine_knn_reference, refine_nn, refine_nn_reference, sm_count,
    split_count, split_ranges)

from test_torch_knn_refine import jax_knn
from test_torch_refine import _jax_refine

N_TILES = 16


def _grid(n, seed, hi, pad_to=N_TILES * CHUNK, dup=1):
    """An integer cloud of n points in [0, hi)^3 (each point ``dup`` times:
    exactly tied distances), Morton-sorted on the CPU."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, hi, (n // dup, 3)).astype(np.float64)
    pts = np.concatenate([base] * dup)[rng.permutation(n // dup * dup)]
    return Cloud.from_numpy(pts, pad_to=pad_to, device="cpu").get_grid(
        build="device")


@pytest.fixture(scope="module")
def clouds():
    """(query grid, search grid with every point twice, cand (16, 12) of the
    lb order, seed-free ncand with 0, in-range and above-w counts)."""
    qg = _grid(3900, 1, 40)
    bg = _grid(3800, 2, 40, dup=2)
    _, _, order = tile_bounds(qg, bg, 3900)
    ncand = torch.tensor([0, 12, 5, 40, 1, 7, 12, 3, 9, 2, 11, 0, 6, 12, 4, 8],
                         dtype=torch.int32)
    return qg, bg, order[:, :12].contiguous(), ncand


def _parts(cand, ncand, splits):
    """(cand, ncand) of each split's call: tile t's slots [begin, end) of
    its live ones, left-aligned (later columns gated off)."""
    nt, w = cand.shape
    live = (torch.full((nt,), w) if ncand is None
            else torch.clamp(ncand.long(), 0, w))
    out = []
    for lo, hi in split_ranges(live, splits):
        width = max(1, int((hi - lo).max()))
        idx = torch.clamp(lo[:, None] + torch.arange(width), max=w - 1)
        out.append((cand.gather(1, idx).contiguous(), (hi - lo).int()))
    return out


def split_nn(q, b, perm, cand, splits, tiles=None, ncand=None, init=None,
             exclude_self=False):
    """K1's split model: the plain version over each part, seeded in every
    part, merged by the lexicographic minimum."""
    best = None
    for sub, n in _parts(cand, ncand, splits):
        d, i = refine_nn_reference(q, b, perm, sub, tiles, n, init,
                                   exclude_self)
        if best is not None:
            keep = (best[0] < d) | ((best[0] == d) & (best[1] < i))
            d, i = torch.where(keep, best[0], d), torch.where(keep, best[1], i)
        best = (d, i)
    return best


def split_knn(q, b, perm, cand, k, splits, tiles=None, ncand=None, init=None,
              exclude_self=False, seed_parts=(0,)):
    """K3's split model: the plain version over each part, the seed in the
    parts ``seed_parts``, merged as the kernel's leader merges: the first k
    of the parts' k-lists in lexicographic order, copies kept (the parts'
    (inf, INT_MAX) tails sort last)."""
    ds, ids = [], []
    for s, (sub, n) in enumerate(_parts(cand, ncand, splits)):
        d, i = refine_knn_reference(q, b, perm, sub, k, tiles, n,
                                    init if s in seed_parts else None,
                                    exclude_self)
        ds.append(d)
        ids.append(i)
    d, i = torch.cat(ds, 2), torch.cat(ids, 2)
    by_id = torch.argsort(i, dim=2, stable=True)
    d, i = d.gather(2, by_id), i.gather(2, by_id)
    by_d = torch.argsort(d, dim=2, stable=True)[..., :k]
    return d.gather(2, by_d), i.gather(2, by_d)


def _assert_same(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


H100_SMS = 132


def test_split_count_properties():
    # probe and extension shapes (thousands of tiles): one block a tile
    for nt, w in ((3328, 8), (3328, 24), (1920, 56), (8192, 8), (528, 832)):
        assert split_count(nt, w, H100_SMS) == 1
    # tier B (a few dozen tiles of hundreds of slots): the full cluster
    assert split_count(32, 704, H100_SMS) == MAX_SPLITS
    assert split_count(16, 832, H100_SMS) == MAX_SPLITS
    # tier A: enough blocks to fill the card, so fewer on a smaller one
    assert split_count(256, 96, H100_SMS) == 3
    assert split_count(256, 96, H100_SMS // 2) == 2
    for sms in (16, H100_SMS):
        for nt in (1, 2, 7, 32, 100, 255, 600, 5000):
            for w in (1, 8, 15, 16, 17, 40, 96, 512, 1000):
                s = split_count(nt, w, sms)
                assert 1 <= s <= MAX_SPLITS  # the portable cluster size
                assert s <= -(-w // 16)  # no split is left below 16 slots
    assert split_count(0, 10, H100_SMS) == split_count(10, 0, H100_SMS) == 1


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 13])
def test_split_ranges_cover_the_live_range(splits):
    """Disjoint parts covering [0, live) in order, none past live, none
    empty while live >= splits, lengths within one of each other."""
    live = torch.arange(0, 60)
    parts = split_ranges(live, splits)
    assert torch.equal(parts[0][0], torch.zeros_like(live))
    assert torch.equal(parts[-1][1], live)
    for (lo, hi), (lo2, _) in zip(parts, parts[1:]):
        assert torch.equal(hi, lo2)
    lens = torch.stack([hi - lo for lo, hi in parts])
    assert bool((lens >= 0).all()) and bool((lens.amax(0) - lens.amin(0) <= 1).all())
    assert bool((lens[:, live >= splits] > 0).all())


@pytest.fixture(scope="module")
def unsplit(clouds):
    """Each case the split models are held to, with its unsplit plain
    result, computed once: {name: (args, kw, result)} (K3 cases carry k
    in kw)."""
    qg, bg, cand, ncand = clouds
    args = (qg.points, bg.points, bg.perm, cand)
    _, _, order_s = tile_bounds(qg, qg, 3900)
    tiles = torch.tensor([13, 2, 7, 0, 15], dtype=torch.int32)
    self_args = (qg.points, qg.points, qg.perm)
    nn_seed = refine_nn_reference(*args[:3], cand[:, :1].contiguous())
    knn_seed = refine_knn_reference(*args[:3], cand[:, :1].contiguous(), 8)
    rest = (*args[:3], cand[:, 1:].contiguous())
    cases = {
        "nn gated": (args, dict(ncand=ncand)),
        "nn seeded": (args, dict(ncand=ncand, init=nn_seed)),
        "nn all slots": (args, {}),
        # self search on compacted tiles: global row ids exclude the column
        "nn self": ((*self_args, order_s[tiles.long(), :12].contiguous()),
                    dict(tiles=tiles, ncand=ncand[:5], exclude_self=True)),
        "knn seeded": (rest, dict(k=8, ncand=ncand - 1, init=knn_seed)),
        "knn gated": (args, dict(k=8, ncand=ncand)),
        # a 30-NN on compacted self tiles with one or two live chunks: rows
        # with fewer than k finite candidates end in (inf, INT_MAX)
        "knn self": ((*self_args, order_s[tiles.long(), :3].contiguous()),
                     dict(k=30, tiles=tiles, exclude_self=True,
                          ncand=torch.tensor([1, 0, 2, 3, 1],
                                             dtype=torch.int32))),
    }
    return {name: (a, kw, (refine_knn_reference(*a, **kw) if "k" in kw
                           else refine_nn_reference(*a, **kw)))
            for name, (a, kw) in cases.items()}


@pytest.mark.parametrize("splits", [1, 2, 3, 12])
def test_nn_split_equals_unsplit(clouds, unsplit, splits):
    """Ties (every search point twice), ncand 0, in range and above w,
    seeds in every part, and exclude_self on compacted global tiles."""
    qg = clouds[0]
    for name in ("nn gated", "nn seeded", "nn all slots", "nn self"):
        args, kw, want = unsplit[name]
        got = split_nn(*args, splits, **kw)
        _assert_same(got, want)
    own = qg.perm.reshape(N_TILES, CHUNK)[kw["tiles"].long()]
    assert not bool((got[1] == own).any())


@pytest.mark.parametrize("splits", [1, 2, 3, 12])
def test_knn_split_equals_unsplit(unsplit, splits):
    """As for K1, with the seed entering part 0 only; rows of gated tiles
    and of self tiles with few live chunks keep (inf, INT_MAX) tails."""
    for name in ("knn seeded", "knn gated", "knn self"):
        args, kw, want = unsplit[name]
        kw = dict(kw)
        got = split_knn(*args, kw.pop("k"), splits, **kw)
        _assert_same(got, want)
    open_rows = torch.isinf(got[0][..., -1])
    assert bool(open_rows[1].all()) and bool((got[1][open_rows][..., -1]
                                              == INT_MAX).all())


def test_knn_seed_in_every_part_duplicates_members(clouds):
    """The hazard the kernel avoids: a seed entering more than one part
    keeps two copies of its members."""
    qg, bg, cand, ncand = clouds
    k = 8
    seed = refine_knn_reference(qg.points, bg.points, bg.perm,
                                cand[:, :1].contiguous(), k)
    rargs = (qg.points, bg.points, bg.perm, cand[:, 1:].contiguous())
    _, ids = split_knn(*rargs, k, 3, init=seed, seed_parts=(0, 1, 2))
    first_two = ids[..., 0] == ids[..., 1]
    assert bool(first_two.any())
    _, ids = split_knn(*rargs, k, 3, init=seed)
    assert not bool((ids[..., 0] == ids[..., 1]).any())


def _candidates(q, b, perm, cand, ncand, tiles, exclude_self):
    """(d, id) of every live candidate of each tile row, (nt, 256, w*256):
    the plain version's distances, dead and self columns (inf, INT_MAX)."""
    nt, w = cand.shape
    t = torch.arange(nt) if tiles is None else tiles.long()
    c = cand.long()
    pts = b.reshape(-1, CHUNK, 3)[c].reshape(nt, 1, w * CHUNK, 3)
    d = _offsets(q.reshape(-1, CHUNK, 3)[t], pts)[3]
    ids = perm.reshape(-1, CHUNK)[c].reshape(nt, 1, -1).expand(d.shape)
    slot = torch.arange(w).repeat_interleave(CHUNK)
    dead = slot[None, None, :] >= torch.clamp(ncand.long(), 0, w)[:, None,
                                                                  None]
    if exclude_self:
        dead = dead | _self_mask(t, c)
    return (torch.where(dead, torch.inf, d), torch.where(dead, INT_MAX, ids))


def _lex_below(d, i, td, ti):
    return (d < td) | ((d == td) & (i < ti))


@pytest.mark.parametrize("seeded", [False, True])
def test_knn_thresholds_drop_no_member(clouds, seeded):
    """K3's pre-insertion thresholds: in each part, T (the k-th smallest of
    the two smallest d of each of the 32 strided groups, column j of every
    chunk in group j % 32, over the part's live chunks, self column
    excluded) and the seed's k-th pair. Dropping every candidate not below
    them leaves the k-best of seed plus candidates unchanged, ties
    included."""
    qg, _, _, ncand = clouds
    k = 30
    _, _, order_s = tile_bounds(qg, qg, 3900)
    cand = order_s[:, :12].contiguous()
    args = (qg.points, qg.points, qg.perm, cand)
    init = (refine_knn_reference(*args[:3], order_s[:, 12:13].contiguous(), k,
                                 exclude_self=True) if seeded else None)
    d, ids = _candidates(*args, ncand, None, True)
    want = refine_knn_reference(*args, k, ncand=ncand, init=init,
                                exclude_self=True)
    nt, w = cand.shape
    slot = torch.arange(w * CHUNK) // CHUNK
    keep = torch.zeros(d.shape, dtype=torch.bool)
    dropped = 0
    for lo, hi in split_ranges(torch.clamp(ncand.long(), 0, w), 3):
        mine = (slot[None, :] >= lo[:, None]) & (slot[None, :] < hi[:, None])
        dm = torch.where(mine[:, None, :], d, torch.inf)
        two = dm.reshape(nt, CHUNK, -1, 32).topk(2, dim=2, largest=False)[0]
        td = two.reshape(nt, CHUNK, 64).sort(dim=2).values[..., k - 1]
        ti = torch.full_like(ids[..., 0], INT_MAX)
        if init is not None:
            sd, si = init[0][..., -1], init[1][..., -1]
            use = _lex_below(sd, si, td, ti)
            td, ti = torch.where(use, sd, td), torch.where(use, si, ti)
        below = _lex_below(d, ids, td[..., None], ti[..., None])
        keep |= mine[:, None, :] & below
        dropped += int((mine[:, None, :] & ~below & torch.isfinite(d)).sum())
    assert dropped > 0  # the thresholds bite
    dk = torch.where(keep, d, torch.inf)
    ik = torch.where(keep, ids, INT_MAX)
    if init is not None:
        dk, ik = torch.cat([init[0], dk], 2), torch.cat([init[1], ik], 2)
    _assert_same(_extract_k(dk, ik, k), want)


@pytest.mark.parametrize("jitter", [0.0, 0.37])
def test_word_box_bound_never_exceeds_d(jitter):
    """The kernels' word skip: the bound from a query to the box of a
    word, the 32 records one warp staged (``pcc::point_box_lb``, the point
    box's ``bbox_lower_bounds``), never exceeds the distance of a record
    in it, on integer clouds full of ties, jittered clouds and padding
    rows. So a warp that skips a word whose bound is above every row's
    threshold drops no candidate that could enter."""
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 40, (3000, 3)) + jitter * rng.standard_normal(
        (3000, 3))
    g = Cloud.from_numpy(pts, pad_to=N_TILES * CHUNK, device="cpu").get_grid(
        build="device")
    words = g.points.reshape(-1, 32, 3)
    lb = bbox_lower_bounds(g.points, g.points, words.amin(1), words.amax(1))
    d = _offsets(g.points.reshape(N_TILES, CHUNK, 3),
                 g.points.reshape(1, 1, -1, 3).expand(N_TILES, 1, -1, 3))[3]
    dmin = d.reshape(N_TILES * CHUNK, -1, 32).amin(2)
    assert bool((lb <= dmin).all())
    assert bool((lb == dmin).any()) and float((lb > 0).float().mean()) > 0.5


def test_split_models_match_jax(clouds):
    """One split case of each kernel against the JAX package's Pallas
    kernel in interpret mode: K1 seeded and gated on compacted tiles, K3
    seeded and gated over the full tile range."""
    qg, bg, cand, ncand = clouds
    tiles = torch.tensor([13, 2, 7, 9, 0, 15, 4, 11], dtype=torch.int32)
    tl = tiles.long()
    seed = refine_nn_reference(qg.points, bg.points, bg.perm,
                               cand[:, :1].contiguous())
    sub = cand[tl, 1:].contiguous()
    n = torch.clamp(ncand[tl] - 1, min=0)
    init = (seed[0][tl].contiguous(), seed[1][tl].contiguous())
    got = split_nn(qg.points, bg.points, bg.perm, sub, 3, tiles=tiles,
                   ncand=n, init=init)
    cols = (tiles.numpy()[:, None] * CHUNK + np.arange(CHUNK)).reshape(-1)
    want = _jax_refine(qg, bg, sub, ncand=n, init=init, q_cols=cols)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])

    k = 8
    kseed = refine_knn_reference(qg.points, bg.points, bg.perm,
                                 cand[:, :1].contiguous(), k)
    rest = cand[:, 1:].contiguous()
    n = torch.clamp(ncand - 1, min=0)
    got = split_knn(qg.points, bg.points, bg.perm, rest, k, 3, ncand=n,
                    init=kseed)
    want = jax_knn(qg, bg, rest, k=k, ncand=n, init=kseed)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_cpu_wrappers_take_splits(clouds):
    """On CPU tensors ``splits`` changes nothing (the plain version runs)
    and counts no launch; a count outside [1, MAX_SPLITS] raises."""
    qg, bg, cand, ncand = clouds
    args = (qg.points, bg.points, bg.perm, cand)
    before = (refine_nn.launches, refine_knn.launches)
    _assert_same(refine_nn(*args, ncand=ncand, splits=3),
                 refine_nn_reference(*args, ncand=ncand))
    _assert_same(refine_knn(*args, 4, ncand=ncand, splits=MAX_SPLITS),
                 refine_knn_reference(*args, 4, ncand=ncand))
    assert (refine_nn.launches, refine_knn.launches) == before
    for bad in (0, MAX_SPLITS + 1):
        with pytest.raises(ValueError):
            refine_nn(*args, splits=bad)
        with pytest.raises(ValueError):
            refine_knn(*args, 4, splits=bad)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the split kernels have no CPU mode")
    return torch.device("cuda")


def _tier_b(dev, exclude_self):
    """A tier-B call on the card: 6 compacted query tiles (one gated off,
    one above w), each over 832 chunks of its lb order, seeded from its
    first 4 chunks, on clouds of 220000 points (every point twice): (args,
    kw of the K1 call, kw of the K3 call)."""
    rng = np.random.default_rng(21)
    qpts = rng.integers(0, 160, (110_000, 3)).astype(np.float64)
    q = Cloud.from_numpy(np.concatenate([qpts, qpts]), device=dev)
    if exclude_self:
        b = q
    else:
        bpts = rng.integers(0, 160, (110_000, 3)).astype(np.float64)
        b = Cloud.from_numpy(np.concatenate([bpts, bpts]), device=dev)
    qg, bg = q.get_grid(build="device"), b.get_grid(build="device")
    _, _, order = tile_bounds(qg, bg, q.n)
    w = 832
    tiles = torch.tensor([3, 0, 412, 8, 815, 1], dtype=torch.int32,
                         device=dev)
    tl = tiles.long()
    cand = order[tl, 4:4 + w].contiguous()
    ncand = torch.tensor([w, 0, w // 2, 3 * w, 17, w - 1], dtype=torch.int32,
                         device=dev)
    args = (qg.points, bg.points, bg.perm, cand)
    head = order[tl, :4].contiguous()
    nn_seed = refine_nn_reference(qg.points, bg.points, bg.perm, head,
                                  tiles=tiles, exclude_self=exclude_self)
    knn_seed = refine_knn_reference(qg.points, bg.points, bg.perm, head, 30,
                                    tiles=tiles, exclude_self=exclude_self)
    common = dict(tiles=tiles, ncand=ncand, exclude_self=exclude_self)
    return args, dict(common, init=nn_seed), dict(common, init=knn_seed)


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
def test_cuda_split_kernels_match_plain_at_tier_b(exclude_self, cuda_device):
    """K1 and K3 at a tier-B shape, for split counts 1, 2, 3, 5, 8 and the
    automatic one: bit for bit equal to the plain versions on the card."""
    args, nn_kw, knn_kw = _tier_b(cuda_device, exclude_self)
    want_nn = refine_nn_reference(*args, **nn_kw)
    want_knn = refine_knn_reference(*args, 30, **knn_kw)
    unseeded = {k: v for k, v in knn_kw.items() if k != "init"}
    want_open = refine_knn_reference(*args, 30, **unseeded)
    assert split_count(6, args[3].shape[1], sm_count(args[0].device)) \
        == MAX_SPLITS
    for splits in (1, 2, 3, 5, 8, None):
        before = (refine_nn.launches, refine_knn.launches)
        got_nn = refine_nn(*args, splits=splits, **nn_kw)
        got_knn = refine_knn(*args, 30, splits=splits, **knn_kw)
        got_open = refine_knn(*args, 30, splits=splits, **unseeded)
        torch.cuda.synchronize()
        assert (refine_nn.launches, refine_knn.launches) == (
            before[0] + 1, before[1] + 2)
        _assert_same(got_nn, want_nn)
        _assert_same(got_knn, want_knn)
        _assert_same(got_open, want_open)


@pytest.mark.cuda
def test_cuda_split_probe_shapes_match_plain(cuda_device):
    """The unseeded K3 probe (its buffers start open, so the first chunk
    sets the group bound) and K1's, forced to split as well, on a cloud
    whose points all appear twice."""
    q = Cloud.from_numpy(np.repeat(np.random.default_rng(22).integers(
        0, 48, (2000, 3)).astype(np.float64), 2, axis=0), device=cuda_device)
    g = q.get_grid(build="device")
    _, _, order = tile_bounds(g, g, q.n)
    args = (g.points, g.points, g.perm, order[:, :8].contiguous())
    for ex in (False, True):
        want_nn = refine_nn_reference(*args, exclude_self=ex)
        want_knn = refine_knn_reference(*args, 30, exclude_self=ex)
        for splits in (1, 2, 8):
            _assert_same(refine_nn(*args, exclude_self=ex, splits=splits),
                         want_nn)
            _assert_same(refine_knn(*args, 30, exclude_self=ex,
                                    splits=splits), want_knn)
