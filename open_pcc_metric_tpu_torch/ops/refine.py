"""The refine kernels: K1 (1-NN), K6 (1-NN with payload), K3 (k-NN), K4
(k-NN moment sums), and the fixed-cap schedules' K2c, K1b, K1c and K3b.

Each refines 256-query tiles over candidate chunks of a Morton grid:

  * ``refine_nn`` (K1) keeps the lexicographic (d, original id) minimum:
    every pruned 1-NN pass (probe, gated extension, both certificate tiers,
    cross and self) runs it. Kernel ``csrc/refine_nn.cu``, the port of
    ``refine_pallas.py`` ``refine_nn_pallas_t``, with its expanded-norm mode
    (``expanded=True``) for clouds that pass ``Cloud.mxu_exact``.
  * ``refine_nn_payload`` (K6) is K1 without gate or seed that also returns
    the winner's ``PAYLOAD_F``-float payload row: the cross sweeps of the
    payload schedule (``nn_pruned.nn_pruned_sorted_payload``) run it.
    Kernel ``csrc/refine_nn_payload.cu``, the port of
    ``refine_nn_pallas_payload``, on K1's step, scan and word skip
    (``csrc/pcc_nn.cuh``).
  * ``refine_knn`` (K3) keeps the k lexicographically smallest pairs: the
    pruned k-NN of the normal estimation runs it. Kernel
    ``csrc/refine_knn.cu``, the port of ``refine_knn_pallas_t``.
  * ``knn_moments`` (K4) sums the query-relative offsets of each query's
    exact k-NN set: the normals come from these sums. Kernel
    ``csrc/knn_moments.cu``, the port of ``moments_pallas_t``.

The fixed-cap schedules' stage 1 (``nn_pruned``, ``knn_pruned``) runs:

  * ``select_candidates`` (K2c): each row's ``cap`` smallest entries of
    the (nta, ncb) lower-bound matrix. Kernel ``csrc/select_candidates.cu``,
    the port of ``select_candidates_pallas``.
  * ``refine_nn_straight`` (K1b): K1 without gate or seed, on K1's
    steps, word skip and split. Kernel ``csrc/refine_nn_straight.cu``, the
    port of ``refine_nn_pallas``. ``refine_nn_fused`` (K1c) computes the
    same with double-buffered asynchronous chunk copies; no schedule calls
    it.
    Kernel ``csrc/refine_nn_fused.cu``, the port of
    ``refine_nn_pallas_fused``.
  * ``refine_knn_straight`` (K3b): K3 without gate or seed, merging a
    chunk only where it can change a buffer. Kernel
    ``csrc/refine_knn_straight.cu``, the port of ``refine_knn_pallas``.

K1, K1b, K3, K4 and K7 (``refine_adaptive.py``) split each tile's live
slots over a thread-block cluster of ``split_count(nt, w, sms)`` blocks (1
at probe shapes, up to ``MAX_SPLITS`` in the tiers) and merge the parts on
chip; ``split_ranges`` is the parts' rule. The split changes no result
(K4's sums only by float32 summation order), and neither does the kernels'
skip of 32 staged records whose box a warp's rows are all bounded away
from (K1, K1b, K3, K4, K6, K7; in the expanded form only below a guard on
the row's best d), nor K3b's and K4's skip of slots by chunk box.

On CUDA tensors each wrapper launches its hand-written kernel on the
current stream (or raises); on CPU tensors it runs its plain PyTorch
version (``*_reference``), which is also what the kernel is checked against
on the card. All compute the squared distance as ((dx^2 + dy^2) + dz^2)
with dx = b - q, each step rounded on its own, so K4's membership test
sees the distances K3 kept. K1's expanded mode and the adaptive refine
(``refine_adaptive.py``, K7) use ``_expanded`` instead.
"""
from __future__ import annotations

import ctypes
import typing

import torch

from .grid import CHUNK

INT_MAX = torch.iinfo(torch.int32).max
MOM_CH = 10  # [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz]
MAX_K = 32  # the largest k one K3 build serves
PAYLOAD_F = 16  # K6 payload rows: [pts 3, col 3, nrm 3, 0 x 7]
# K1, K3 and K4 split a tile's slot range over a cluster of up to MAX_SPLITS
# blocks (the portable cluster size, pcc::kMaxSplits), aiming at
# SPLIT_BLOCKS_PER_SM blocks for each SM of the device in all, and give no
# split fewer than MIN_SPLIT_SLOTS slots of the call's width.
MAX_SPLITS = 8
SPLIT_BLOCKS_PER_SM = 4
MIN_SPLIT_SLOTS = 16
# K1c's chunks a step, two steps (the one scanned, the one in flight) in
# K1b's 8-chunk buffer (csrc/pcc_nn.cuh kAsyncDepth).
ASYNC_DEPTH = 4

# The plain versions materialise (tiles, 256, slots * 256) blocks; this
# bounds one block's element count (64 MB of float32).
_REF_BLOCK_ELEMS = 1 << 24

Init = typing.Optional[typing.Tuple[torch.Tensor, torch.Tensor]]
Opt = typing.Optional[torch.Tensor]


def _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand):
    if q_sorted.ndim != 2 or q_sorted.shape[1] != 3 or q_sorted.shape[0] % CHUNK:
        raise ValueError(f"q_sorted must be (Pa, 3), Pa % {CHUNK} == 0; "
                         f"got {tuple(q_sorted.shape)}")
    if b_sorted.ndim != 2 or b_sorted.shape[1] != 3 or b_sorted.shape[0] % CHUNK:
        raise ValueError(f"b_sorted must be (Pb, 3), Pb % {CHUNK} == 0; "
                         f"got {tuple(b_sorted.shape)}")
    if b_sorted.dtype != q_sorted.dtype:
        raise ValueError("q_sorted and b_sorted dtypes differ")
    if tuple(b_orig.shape) != (b_sorted.shape[0],):
        raise ValueError(f"b_orig must be ({b_sorted.shape[0]},)")
    if cand.ndim != 2:
        raise ValueError(f"cand must be (nt, w); got {tuple(cand.shape)}")
    nt = cand.shape[0]
    int_args = {"b_orig": b_orig, "cand": cand}
    for name, x in (("tiles", tiles), ("ncand", ncand)):
        if x is not None:
            if tuple(x.shape) != (nt,):
                raise ValueError(f"{name} must be ({nt},)")
            int_args[name] = x
    if tiles is None and nt > q_sorted.shape[0] // CHUNK:
        raise ValueError("more candidate rows than query tiles")
    for name, x in int_args.items():
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")


def _check_pair(name, d, i, shape, dtype):
    """A (distances, ids) pair of the given shape: (dtype, int32)."""
    if tuple(d.shape) != shape or tuple(i.shape) != shape:
        raise ValueError(f"{name} must be two {shape} tensors")
    if d.dtype != dtype or i.dtype != torch.int32:
        raise ValueError(f"{name} must be (points dtype, int32)")


def _check_k(k: int):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def split_count(nt: int, w: int, sms: int) -> int:
    """K1's, K3's and K4's blocks per tile for a call of ``nt`` tiles and
    ``w`` slots on a device of ``sms`` SMs, from the shapes alone (no
    readback): enough to reach SPLIT_BLOCKS_PER_SM blocks an SM, at most
    MAX_SPLITS and at most one per MIN_SPLIT_SLOTS slots. On an H100 (132 SMs): 1 at
    probe shapes (thousands of tiles), 8 in tier B (a few dozen tiles of
    hundreds of slots)."""
    if nt <= 0 or w <= 0:
        return 1
    want = -(-SPLIT_BLOCKS_PER_SM * sms // nt)
    return max(1, min(want, MAX_SPLITS, -(-w // MIN_SPLIT_SLOTS)))


def sm_count(device: torch.device) -> int:
    """The SM count of CUDA ``device``, which ``split_count`` sizes for."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_ranges(live: torch.Tensor, splits: int):
    """[(begin, end)] of each split: split s of a tile walks slots
    [floor(s * live / S), floor((s + 1) * live / S)) of its ``live`` ones,
    the kernels' ``pcc::split_begin`` rule. Disjoint, covering [0, live),
    lengths differing by at most one."""
    live = live.long()
    return [((s * live) // splits, ((s + 1) * live) // splits)
            for s in range(splits)]


def _check_boxes(boxes, b_sorted) -> None:
    """``boxes``: the search grid's two (Pb / 256, 3) chunk-box corners
    (``bbox_lo``, ``bbox_hi``) of the points' dtype."""
    shape = (b_sorted.shape[0] // CHUNK, 3)
    if boxes is None or len(boxes) != 2 or any(tuple(x.shape) != shape
                              or x.dtype != b_sorted.dtype for x in boxes):
        raise ValueError(f"boxes must be two {shape} tensors of the "
                         "points' dtype")


def _check_splits(splits) -> None:
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be in [1, {MAX_SPLITS}], got {splits}")


def _offsets(q: torch.Tensor, pts: torch.Tensor):
    """(dx, dy, dz, d) of candidates ``pts`` (n, 1, m, 3) from queries
    ``q`` (n, 256, 3): dx = b - q and d = ((dx^2 + dy^2) + dz^2), the
    kernels' rounding."""
    diffs = [pts[..., c] - q[:, :, None, c] for c in range(3)]
    d = None
    for diff in diffs:
        sq = diff * diff
        d = sq if d is None else d + sq  # (n, 256, m)
    return (*diffs, d)


def sq_norm(points: torch.Tensor) -> torch.Tensor:
    """(P,) ((x*x + y*y) + z*z) of (P, 3) points, each step rounded on its
    own (``pcc::sq_norm``)."""
    x, y, z = points.unbind(dim=1)
    return (x * x + y * y) + z * z


def expanded_queries(points: torch.Tensor) -> torch.Tensor:
    """(P, 4) queries packed for the expanded-norm distance:
    (-2x, -2y, -2z, |q|^2)."""
    return torch.cat([-2.0 * points, sq_norm(points)[:, None]], dim=1)


def expanded_candidates(points: torch.Tensor) -> torch.Tensor:
    """(P, 4) candidates packed for the expanded-norm distance:
    (x, y, z, |b|^2)."""
    return torch.cat([points, sq_norm(points)[:, None]], dim=1)


def _expanded(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Expanded-norm d of candidates ``pts`` (n, 1, m, 4) from queries ``q``
    (n, 256, 4), packed as ``expanded_candidates`` / ``expanded_queries``:
    (((|b|^2 + |q|^2) + bx*(-2qx)) + by*(-2qy)) + bz*(-2qz), each step
    rounded on its own. ``pcc::expanded`` takes the same order with fused
    multiply-adds; both equal the difference form bit for bit on clouds
    that pass ``Cloud.mxu_exact`` (for pairs closer than 2557 units), and
    neither is exact on sentinel rows."""
    d = pts[..., 3] + q[:, :, None, 3]
    for c in range(3):
        d = d + pts[..., c] * q[:, :, None, c]
    return d


def _difference(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return _offsets(q, pts)[3]


def _blocks(q_sorted, b_sorted, b_orig, cand, tiles, row_elems):
    """Batches of tiles for the plain versions: yields (s, e, q, pts, ids,
    t, c) with q (n, 256, f) the queries, pts (n, 1, w*256, f) and ids
    (n, 1, w*256) the candidates, t and c the tile and chunk ids (int64),
    where f is the points' width (3, or 4 when packed for ``_expanded``)."""
    nt, w = cand.shape
    f = q_sorted.shape[1]
    q_tiles = q_sorted.reshape(-1, CHUNK, f)
    b_chunks = b_sorted.reshape(-1, CHUNK, f)
    o_chunks = b_orig.reshape(-1, CHUNK)
    if tiles is None:
        tiles = torch.arange(nt, dtype=torch.int32, device=q_sorted.device)
    bt = max(1, _REF_BLOCK_ELEMS // max(1, row_elems * CHUNK))
    for s in range(0, nt, bt):
        e = min(nt, s + bt)
        t, c = tiles[s:e].long(), cand[s:e].long()
        n = e - s
        yield (s, e, q_tiles[t], b_chunks[c].reshape(n, 1, w * CHUNK, f),
               o_chunks[c].reshape(n, 1, w * CHUNK), t, c)


def _live(ncand, s, e, w, dev):
    """(n, 1, w*256) mask of the candidates in live slots, or None."""
    if ncand is None:
        return None
    slot = torch.arange(w, dtype=torch.int32, device=dev)
    return (slot[None, :] < ncand[s:e, None]).repeat_interleave(
        CHUNK, dim=1)[:, None, :]


def _self_mask(t, c):
    """(n, 256, w*256) mask of the column that is the query row itself."""
    lane = torch.arange(CHUNK, device=t.device)
    n = t.shape[0]
    gcol = (c[:, :, None] * CHUNK + lane).reshape(n, 1, -1)
    grow = (t[:, None] * CHUNK + lane)[:, :, None]
    return grow == gcol


# ---------------------------------------------------------------- K1


def refine_nn_reference(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    tiles: Opt = None,
    ncand: Opt = None,
    init: Init = None,
    exclude_self: bool = False,
    expanded: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1, on any device and float dtype.

    Returns ((nt, 256) min squared distance, (nt, 256) original id): for
    query row r of tile ``tiles[t]`` (default t), the lexicographic minimum
    of (d, b_orig[col]) over the columns of chunks ``cand[t, :ncand[t]]``
    (all of ``cand[t]`` when ncand is None), merged with ``init[t]``. The
    distance sums (b - q)^2 over x, y, z in that order, or with
    ``expanded`` is the expanded-norm form (``_expanded``), which only
    callers of clouds that pass ``Cloud.mxu_exact`` may ask for. Works over
    batches of tiles, like the JAX package's ``refine_xla``.
    """
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand)
    nt, w = cand.shape
    if init is not None:
        _check_pair("init", *init, (nt, CHUNK), q_sorted.dtype)
    if expanded:
        return _lexmin(expanded_queries(q_sorted),
                       expanded_candidates(b_sorted), b_orig, cand, tiles,
                       ncand, init, exclude_self, _expanded)
    return _lexmin(q_sorted, b_sorted, b_orig, cand, tiles, ncand, init,
                   exclude_self, _difference)


def _lexmin(q, b, b_orig, cand, tiles, ncand, init, exclude_self, dist):
    """The 1-NN refines' plain body over (P, f) queries and candidates:
    ``dist(q_block, pts_block)`` gives the distances."""
    nt, w = cand.shape
    dev = q.device
    out_d = torch.empty((nt, CHUNK), dtype=q.dtype, device=dev)
    out_i = torch.empty((nt, CHUNK), dtype=torch.int32, device=dev)
    for s, e, qb, pts, ids, t, c in _blocks(q, b, b_orig, cand, tiles,
                                            w * CHUNK):
        d = dist(qb, pts)
        live = _live(ncand, s, e, w, dev)
        if live is not None:
            d = torch.where(live, d, torch.inf)
            ids = torch.where(live, ids, INT_MAX)
        if exclude_self:
            d = torch.where(_self_mask(t, c), torch.inf, d)
        dmin = d.amin(dim=2)
        gidx = torch.where(d == dmin[..., None], ids, INT_MAX).amin(dim=2)
        if init is not None:
            pd, pi = init[0][s:e], init[1][s:e]
            better = (dmin < pd) | ((dmin == pd) & (gidx < pi))
            dmin = torch.where(better, dmin, pd)
            gidx = torch.where(better, gidx, pi)
        out_d[s:e] = dmin
        out_i[s:e] = gidx
    return out_d, out_i


# ---------------------------------------------------------------- K6


def _check_payload(pay_sorted, b_sorted):
    if (tuple(pay_sorted.shape) != (b_sorted.shape[0], PAYLOAD_F)
            or pay_sorted.dtype != b_sorted.dtype):
        raise ValueError(f"pay_sorted must be ({b_sorted.shape[0]}, "
                         f"{PAYLOAD_F}) of the points dtype")


def refine_nn_payload_reference(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    pay_sorted: torch.Tensor,
    cand: torch.Tensor,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K6, on any device and float dtype.

    Returns ((nt, 256) d, (nt, 256) id, (nt * 256, PAYLOAD_F) payload): d
    and id as ``refine_nn_reference`` over every slot of ``cand`` (no gate,
    no seed), and the payload row ``pay_sorted[col]`` at the winning sorted
    column col (the lowest original id among the minima), zeros where no
    candidate won. ``pay_sorted`` lies in the candidates' sorted order, so
    the payload equals a gather of the original-order payload at the id.
    """
    _check(q_sorted, b_sorted, b_orig, cand, None, None)
    _check_payload(pay_sorted, b_sorted)
    nt, w = cand.shape
    dev = q_sorted.device
    out_d = torch.full((nt, CHUNK), torch.inf, dtype=q_sorted.dtype,
                       device=dev)
    out_i = torch.full((nt, CHUNK), INT_MAX, dtype=torch.int32, device=dev)
    out_p = torch.zeros((nt, CHUNK, PAYLOAD_F), dtype=q_sorted.dtype,
                        device=dev)
    for s, e, q, pts, ids, t, c in _blocks(q_sorted, b_sorted, b_orig, cand,
                                           None, 2 * w * CHUNK) if w else ():
        d = _difference(q, pts)
        if exclude_self:
            d = torch.where(_self_mask(t, c), torch.inf, d)
        dmin = d.amin(dim=2)
        at_min = d == dmin[..., None]
        gidx = torch.where(at_min, ids, INT_MAX).amin(dim=2)
        win = at_min & (ids == gidx[..., None])
        pos = win.to(torch.int8).argmax(dim=2)  # the first winning position
        col = c.gather(1, pos // CHUNK) * CHUNK + pos % CHUNK
        out_p[s:e] = torch.where(win.any(dim=2)[..., None],
                                 pay_sorted[col], 0)
        out_d[s:e] = dmin
        out_i[s:e] = gidx
    return out_d, out_i, out_p.reshape(nt * CHUNK, PAYLOAD_F)


# ---------------------------------------------------------------- K3


def _extract_k(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The ascending k smallest distinct (d, id) pairs over the last axis,
    ending in (inf, INT_MAX) where a row has fewer: the result of the JAX
    package's ``_extract_k`` (k rounds of the lexicographic minimum), from
    stable sorts: by id, then by d; a pair equal to its left neighbour is a
    repeat, and the first k others are scattered to their ranks among the
    kept pairs."""
    if d.shape[-1] < k:
        pad = d.shape[:-1] + (k - d.shape[-1],)
        d = torch.cat([d, d.new_full(pad, torch.inf)], dim=-1)
        ids = torch.cat([ids, ids.new_full(pad, INT_MAX)], dim=-1)
    o = torch.sort(ids, dim=-1, stable=True).indices
    d, ids = d.gather(-1, o), ids.gather(-1, o)
    o = torch.sort(d, dim=-1, stable=True).indices
    d, ids = d.gather(-1, o), ids.gather(-1, o)
    keep = torch.ones_like(ids, dtype=torch.bool)
    keep[..., 1:] = (d[..., 1:] != d[..., :-1]) | (ids[..., 1:] != ids[..., :-1])
    # rank among the kept pairs; repeats and ranks >= k land in column k
    rank = torch.where(keep, keep.cumsum(dim=-1) - 1, k).clamp(max=k)
    shape = d.shape[:-1] + (k + 1,)
    return (d.new_full(shape, torch.inf).scatter_(-1, rank, d)[..., :k],
            ids.new_full(shape, INT_MAX).scatter_(-1, rank, ids)[..., :k])


def refine_knn_reference(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    k: int,
    tiles: Opt = None,
    ncand: Opt = None,
    init: Init = None,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3, on any device and float dtype.

    Returns ascending ((nt, 256, k) squared distances, (nt, 256, k) original
    ids): for query row r of tile ``tiles[t]`` (default t), the k
    lexicographically smallest distinct (d, b_orig[col]) pairs of
    ``init[t, r]`` and the columns of chunks ``cand[t, :ncand[t]]`` (all of
    ``cand[t]`` when ncand is None). Only finite distances count: the
    excluded self column (``exclude_self``) never enters, and a row with
    fewer than k finite pairs is filled with (inf, INT32_MAX). Candidate
    rows must not repeat a chunk, within a row or against the chunks that
    built ``init``. The port of the JAX package's ``make_refine`` /
    ``_extract_k``, with the count gate and the seed.
    """
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand)
    _check_k(k)
    nt, w = cand.shape
    if init is not None:
        _check_pair("init", *init, (nt, CHUNK, k), q_sorted.dtype)
    dev = q_sorted.device
    out_d = torch.empty((nt, CHUNK, k), dtype=q_sorted.dtype, device=dev)
    out_i = torch.empty((nt, CHUNK, k), dtype=torch.int32, device=dev)
    for s, e, q, pts, ids, t, c in _blocks(q_sorted, b_sorted, b_orig, cand,
                                           tiles, w * CHUNK + k):
        d = _offsets(q, pts)[3]
        ids = ids.expand(d.shape)
        live = _live(ncand, s, e, w, dev)
        if live is not None:
            d = torch.where(live, d, torch.inf)
        if exclude_self:
            d = torch.where(_self_mask(t, c), torch.inf, d)
        if init is not None:
            d = torch.cat([init[0][s:e], d], dim=2)
            ids = torch.cat([init[1][s:e], ids], dim=2)
        ids = torch.where(torch.isinf(d), INT_MAX, ids)
        out_d[s:e], out_i[s:e] = _extract_k(d, ids, k)
    return out_d, out_i


# ---------------------------------------------------------------- K4


def knn_moments_reference(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    ncand: torch.Tensor,
    rk: torch.Tensor,
    ik: torch.Tensor,
    tiles: Opt = None,
    init: Opt = None,
) -> torch.Tensor:
    """Plain PyTorch K4, on any device and float dtype.

    Returns (nt, 256, MOM_CH) sums [cnt, sx, sy, sz, sxx, syy, szz, sxy,
    sxz, syz] of the offsets b - q from query row r of tile ``tiles[t]``
    (default t) to the columns of chunks ``cand[t, :ncand[t]]`` that are
    members of its k-NN set, (d < rk[t, r]) | (d == rk[t, r] & id <=
    ik[t, r]), added to ``init[t, r]`` (zeros when None). The same
    membership scan over the candidate chunks as the kernel; the sums are
    taken in another order.
    """
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand)
    nt, w = cand.shape
    if ncand is None:
        raise ValueError("knn_moments needs ncand (the per-tile slot gate)")
    _check_pair("(rk, ik)", rk, ik, (nt, CHUNK), q_sorted.dtype)
    if init is not None and (tuple(init.shape) != (nt, CHUNK, MOM_CH)
                             or init.dtype != q_sorted.dtype):
        raise ValueError(f"init must be ({nt}, {CHUNK}, {MOM_CH}) of the "
                         "points dtype")
    dev = q_sorted.device
    out = torch.empty((nt, CHUNK, MOM_CH), dtype=q_sorted.dtype, device=dev)
    for s, e, q, pts, ids, _, _ in _blocks(q_sorted, b_sorted, b_orig, cand,
                                           tiles, w * CHUNK * 2):
        dx, dy, dz, d = _offsets(q, pts)
        r, i = rk[s:e, :, None], ik[s:e, :, None]
        member = _live(ncand, s, e, w, dev) & (
            (d < r) | ((d == r) & (ids <= i)))
        m = member.to(d.dtype)
        mdx, mdy, mdz = m * dx, m * dy, m * dz
        parts = (m, mdx, mdy, mdz, mdx * dx, mdy * dy, mdz * dz,
                 mdx * dy, mdx * dz, mdy * dz)
        mom = torch.stack([p.sum(dim=2) for p in parts], dim=2)
        out[s:e] = mom if init is None else init[s:e] + mom
    return out


# ------------------------------------------------- K2c, K1b, K1c, K3b


def select_candidates_reference(lb: torch.Tensor, cap: int) -> torch.Tensor:
    """Plain PyTorch K2c, on any device and float dtype.

    Returns (nta, cap) int32: what ``cap`` rounds of (the lowest column
    among the row's minima, then mask it to +inf) pick from each row of
    the (nta, ncb) matrix ``lb`` (no NaN), as the JAX package's
    ``select_candidates_pallas`` does. In closed form: the row's stable
    ascending order for its first min(#finite, cap) picks, then column 0,
    the lowest column once every entry left is +inf (so a row of a tile
    without a valid query, all +inf, gives 0, 0, ...).
    """
    _check_select(lb, cap)
    nta, ncb = lb.shape
    order = torch.sort(lb, dim=1, stable=True).indices[:, :cap]
    out = torch.zeros((nta, cap), dtype=torch.int32, device=lb.device)
    out[:, :order.shape[1]] = order.to(torch.int32)
    n_finite = (lb < torch.inf).sum(dim=1, keepdim=True)
    pos = torch.arange(cap, device=lb.device)
    return torch.where(pos < n_finite, out, 0)


def _check_select(lb, cap):
    if lb.ndim != 2 or not lb.is_floating_point():
        raise ValueError(f"lb must be a float (nta, ncb) matrix; got "
                         f"{tuple(lb.shape)} {lb.dtype}")
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")


def refine_nn_straight_reference(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    tiles: Opt = None,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1b and K1c: ``refine_nn_reference`` over every slot
    of ``cand``, without gate or seed (the JAX package's
    ``refine_nn_pallas``)."""
    return refine_nn_reference(q_sorted, b_sorted, b_orig, cand, tiles,
                               exclude_self=exclude_self)


def refine_knn_straight_reference(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    k: int,
    tiles: Opt = None,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3b: ``refine_knn_reference`` over every slot of
    ``cand``, without gate or seed (the JAX package's
    ``refine_knn_pallas``). Rows must not repeat a chunk."""
    return refine_knn_reference(q_sorted, b_sorted, b_orig, cand, k, tiles,
                                exclude_self=exclude_self)


# ---------------------------------------------------------------- launches

# name -> (C entry, number of pointer arguments, number of int arguments[,
# number of float arguments after the ints]); the stream comes last
_ENTRIES = {
    "refine_nn": ("pcc_refine_nn", 10, 5),
    "refine_nn_payload": ("pcc_refine_nn_payload", 8, 3),
    # K7, wrapped by ops/refine_adaptive.adaptive_refine
    "adaptive_refine": ("pcc_adaptive_refine", 9, 6),
    "refine_knn": ("pcc_refine_knn", 10, 5),
    "knn_moments": ("pcc_knn_moments", 12, 3),
    "nn_brute": ("pcc_nn_brute", 4, 4),  # K5, wrapped by ops/nn.nn_argmin
    "knn_brute": ("pcc_knn_brute", 4, 4),  # K8, wrapped by ops/knn.knn
    "select_bbox": ("pcc_select_bbox", 6, 4),  # K2a, ops/select.select_bbox
    "count_bbox": ("pcc_count_bbox", 6, 4, 1),  # K2b, ops/select.count_bbox
    "select_candidates": ("pcc_select_candidates", 2, 4),
    "refine_nn_straight": ("pcc_refine_nn_straight", 7, 4),
    "refine_nn_fused": ("pcc_refine_nn_fused", 7, 4),
    "refine_knn_straight": ("pcc_refine_knn_straight", 9, 4),
    # K9, wrapped by io/ply_decode.decode_records
    "ply_decode": ("pcc_ply_decode", 5, 13),
}


def _ptr(x: Opt):
    return None if x is None else x.data_ptr()


def _entry(name: str):
    """The bound C entry of kernel ``name`` and its library."""
    from . import _build

    lib = _build.load(name).lib
    symbol, n_ptr, n_int, *n_float = _ENTRIES[name]
    fn = getattr(lib, symbol)
    if not getattr(lib, "_pcc_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * n_ptr + [i] * n_int + [f] * sum(n_float) + [p]
        fn.restype = ctypes.c_int
        lib.pcc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pcc_cuda_error_string.restype = ctypes.c_char_p
        lib._pcc_bound = True
    return fn, lib


def _cuda_checks(name: str, q_sorted: torch.Tensor, tensors) -> None:
    if q_sorted.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q_sorted.device}")
    for x in tensors:
        if x is None:
            continue
        if x.device != q_sorted.device:
            raise ValueError(f"{name}: all tensors must be on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if q_sorted.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, not {q_sorted.dtype}")


def _launch(name: str, device: torch.device, ptrs, scalars) -> None:
    fn, lib = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[_ptr(x) for x in ptrs], *scalars, stream)
    if rc != 0:
        msg = lib.pcc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def refine_nn(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    tiles: Opt = None,
    ncand: Opt = None,
    init: Init = None,
    exclude_self: bool = False,
    expanded: bool = False,
    splits: typing.Optional[int] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K1 (see ``refine_nn_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: the kernel takes float32 only, every
    tensor contiguous and on one device, and ``cand``/``tiles`` values must
    index chunks of ``b_sorted`` / tiles of ``q_sorted``. With ``expanded``
    the kernel fuses the expanded form's multiply-adds, so it equals the
    plain version on the valid rows of clouds that pass ``Cloud.mxu_exact``
    only. Each tile's live slots are split over ``splits`` blocks of one
    cluster (``split_count(nt, w, sm_count(device))`` when None; 1 forces
    one block a tile),
    which changes no result: an argument for the tests and chip_smoke.py,
    not a knob. Each launch adds one to ``refine_nn.launches``.
    """
    _check_splits(splits)
    if q_sorted.device.type == "cpu":
        return refine_nn_reference(q_sorted, b_sorted, b_orig, cand, tiles,
                                   ncand, init, exclude_self, expanded)
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand)
    nt, w = cand.shape
    if init is not None:
        _check_pair("init", *init, (nt, CHUNK), q_sorted.dtype)
    init_d, init_i = init if init is not None else (None, None)
    _cuda_checks("refine_nn", q_sorted,
                 [b_sorted, b_orig, cand, tiles, ncand, init_d, init_i])
    out_d = torch.empty((nt, CHUNK), dtype=torch.float32, device=q_sorted.device)
    out_i = torch.empty((nt, CHUNK), dtype=torch.int32, device=q_sorted.device)
    if nt == 0:
        return out_d, out_i
    _launch("refine_nn", q_sorted.device,
            [q_sorted, b_sorted, b_orig, cand, tiles, ncand, init_d, init_i,
             out_d, out_i], [nt, w, int(bool(exclude_self)),
                             int(bool(expanded)),
                             splits or split_count(nt, w,
                                                   sm_count(q_sorted.device))])
    refine_nn.launches += 1
    return out_d, out_i


def refine_nn_payload(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    pay_sorted: torch.Tensor,
    cand: torch.Tensor,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 (see ``refine_nn_payload_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: float32 only, every tensor contiguous and
    on one device, ``pay_sorted`` 16-byte aligned, and ``cand`` values must
    index chunks of ``b_sorted``. Each launch adds one to
    ``refine_nn_payload.launches``.
    """
    if q_sorted.device.type == "cpu":
        return refine_nn_payload_reference(q_sorted, b_sorted, b_orig,
                                           pay_sorted, cand, exclude_self)
    _check(q_sorted, b_sorted, b_orig, cand, None, None)
    _check_payload(pay_sorted, b_sorted)
    _cuda_checks("refine_nn_payload", q_sorted,
                 [b_sorted, b_orig, pay_sorted, cand])
    if pay_sorted.data_ptr() % 16:
        raise ValueError("pay_sorted must be 16-byte aligned")
    nt, w = cand.shape
    dev = q_sorted.device
    out_d = torch.empty((nt, CHUNK), dtype=torch.float32, device=dev)
    out_i = torch.empty((nt, CHUNK), dtype=torch.int32, device=dev)
    out_p = torch.empty((nt * CHUNK, PAYLOAD_F), dtype=torch.float32,
                        device=dev)
    if nt == 0:
        return out_d, out_i, out_p
    _launch("refine_nn_payload", dev,
            [q_sorted, b_sorted, b_orig, pay_sorted, cand, out_d, out_i,
             out_p], [nt, w, int(bool(exclude_self))])
    refine_nn_payload.launches += 1
    return out_d, out_i, out_p


def refine_knn(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    k: int,
    tiles: Opt = None,
    ncand: Opt = None,
    init: Init = None,
    exclude_self: bool = False,
    splits: typing.Optional[int] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K3 (see ``refine_knn_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: the kernel takes float32 only, k <= 32,
    every tensor contiguous and on one device, and ``cand``/``tiles``
    values must index chunks of ``b_sorted`` / tiles of ``q_sorted``.
    ``splits`` as in ``refine_nn``; the seed enters one split only. Each
    launch adds one to ``refine_knn.launches``.
    """
    _check_splits(splits)
    if q_sorted.device.type == "cpu":
        return refine_knn_reference(q_sorted, b_sorted, b_orig, cand, k,
                                    tiles, ncand, init, exclude_self)
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand)
    _check_k(k)
    nt, w = cand.shape
    if init is not None:
        _check_pair("init", *init, (nt, CHUNK, k), q_sorted.dtype)
    init_d, init_i = init if init is not None else (None, None)
    _cuda_checks("refine_knn", q_sorted,
                 [b_sorted, b_orig, cand, tiles, ncand, init_d, init_i])
    dev = q_sorted.device
    out_d = torch.empty((nt, CHUNK, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nt, CHUNK, k), dtype=torch.int32, device=dev)
    if nt == 0:
        return out_d, out_i
    _launch("refine_knn", dev,
            [q_sorted, b_sorted, b_orig, cand, tiles, ncand, init_d, init_i,
             out_d, out_i], [nt, w, k, int(bool(exclude_self)),
                             splits or split_count(nt, w, sm_count(dev))])
    refine_knn.launches += 1
    return out_d, out_i


def knn_moments(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    ncand: torch.Tensor,
    rk: torch.Tensor,
    ik: torch.Tensor,
    tiles: Opt = None,
    init: Opt = None,
    *,
    boxes: typing.Tuple[torch.Tensor, torch.Tensor],
    splits: typing.Optional[int] = None,
) -> torch.Tensor:
    """K4 (see ``knn_moments_reference`` for the contract).

    ``boxes``: the search grid's chunk boxes (``bbox_lo``, ``bbox_hi``) of
    ``b_sorted``, as for ``refine_knn_straight``; the kernel skips a slot
    that every row of a tile is bounded beyond its ``rk`` from, which
    changes no result (the plain version takes no boxes). ``splits`` as in
    ``refine_nn``, with ``init`` entering one split only: the member counts
    do not change; at ``splits=1`` the sums equal the kernel's unsplit
    order bit for bit, and at more splits they differ from it by float32
    summation order only.

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: the kernel takes float32 only, every
    tensor contiguous and on one device, and ``cand``/``tiles`` values must
    index chunks of ``b_sorted`` / tiles of ``q_sorted``. Each launch adds
    one to ``knn_moments.launches``.
    """
    _check_splits(splits)
    _check_boxes(boxes, b_sorted)
    if q_sorted.device.type == "cpu":
        return knn_moments_reference(q_sorted, b_sorted, b_orig, cand, ncand,
                                     rk, ik, tiles, init)
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand)
    nt, w = cand.shape
    if ncand is None:
        raise ValueError("knn_moments needs ncand (the per-tile slot gate)")
    _check_pair("(rk, ik)", rk, ik, (nt, CHUNK), q_sorted.dtype)
    if init is not None and tuple(init.shape) != (nt, CHUNK, MOM_CH):
        raise ValueError(f"init must be ({nt}, {CHUNK}, {MOM_CH})")
    c_lo, c_hi = boxes
    _cuda_checks("knn_moments", q_sorted,
                 [b_sorted, b_orig, cand, tiles, ncand, c_lo, c_hi, rk, ik,
                  init])
    if init is not None and init.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, not {init.dtype}")
    dev = q_sorted.device
    out = torch.empty((nt, CHUNK, MOM_CH), dtype=torch.float32, device=dev)
    if nt == 0:
        return out
    _launch("knn_moments", dev,
            [q_sorted, b_sorted, b_orig, cand, tiles, ncand, c_lo, c_hi, rk,
             ik, init, out],
            [nt, w, splits or split_count(nt, w, sm_count(dev))])
    knn_moments.launches += 1
    return out


def select_candidates(lb: torch.Tensor, cap: int,
                      rounds: bool = False) -> torch.Tensor:
    """K2c (see ``select_candidates_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: float32 and contiguous only. The kernel
    takes a radix select when a row's keys and picks fit in shared memory,
    else its first design (``cap`` rounds of a block argmin); ``rounds``
    forces the first design (a test argument: both give the same picks).
    Each launch adds one to ``select_candidates.launches``.
    """
    if lb.device.type == "cpu":
        return select_candidates_reference(lb, cap)
    _check_select(lb, cap)
    _cuda_checks("select_candidates", lb, [])
    if not lb.is_contiguous():
        raise ValueError("select_candidates: lb must be contiguous")
    nta, ncb = lb.shape
    out = torch.empty((nta, cap), dtype=torch.int32, device=lb.device)
    if nta == 0:
        return out
    _launch("select_candidates", lb.device, [lb, out],
            [nta, ncb, cap, int(not rounds)])
    select_candidates.launches += 1
    return out


def _launch_ungated(wrapper, q_sorted, b_sorted, b_orig, cand, tiles,
                    out_shape, ints, extra=()):
    """The CUDA side of K1b, K1c and K3b: check the inputs, allocate the
    (d, id) outputs of ``out_shape`` and launch the kernel named after
    ``wrapper`` (counting the launch on it) with the pointer arguments
    ``extra`` after ``tiles`` and the int arguments (nt, w, *ints)."""
    name = wrapper.__name__
    _check(q_sorted, b_sorted, b_orig, cand, tiles, None)
    _cuda_checks(name, q_sorted, [b_sorted, b_orig, cand, tiles, *extra])
    dev = q_sorted.device
    out_d = torch.empty(out_shape, dtype=torch.float32, device=dev)
    out_i = torch.empty(out_shape, dtype=torch.int32, device=dev)
    nt, w = cand.shape
    if nt:
        _launch(name, dev, [q_sorted, b_sorted, b_orig, cand, tiles, *extra,
                            out_d, out_i], [nt, w, *ints])
        wrapper.launches += 1
    return out_d, out_i


def refine_nn_straight(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    tiles: Opt = None,
    exclude_self: bool = False,
    splits: typing.Optional[int] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K1b (see ``refine_nn_straight_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: the kernel takes float32 only, every
    tensor contiguous and on one device, and ``cand``/``tiles`` values must
    index chunks of ``b_sorted`` / tiles of ``q_sorted``. Each tile's slots
    are split over ``splits`` blocks of one cluster, as in ``refine_nn``
    (a test argument, not a knob). Each launch adds one to
    ``refine_nn_straight.launches``.
    """
    _check_splits(splits)
    if q_sorted.device.type == "cpu":
        return refine_nn_straight_reference(q_sorted, b_sorted, b_orig, cand,
                                            tiles, exclude_self)
    nt, w = cand.shape
    return _launch_ungated(
        refine_nn_straight, q_sorted, b_sorted, b_orig, cand, tiles,
        (nt, CHUNK), [int(bool(exclude_self)),
                      splits or split_count(nt, w, sm_count(q_sorted.device))])


def refine_nn_fused(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    tiles: Opt = None,
    exclude_self: bool = False,
    splits: typing.Optional[int] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K1c: K1b's function (``refine_nn_straight_reference``) through the
    kernel that copies the next ASYNC_DEPTH chunks while it scans these. No
    schedule calls it.

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise, as K1b; ``splits`` as K1b's (a test
    argument, not a knob). Each launch adds one to
    ``refine_nn_fused.launches``.
    """
    _check_splits(splits)
    if q_sorted.device.type == "cpu":
        return refine_nn_straight_reference(q_sorted, b_sorted, b_orig, cand,
                                            tiles, exclude_self)
    nt, w = cand.shape
    return _launch_ungated(
        refine_nn_fused, q_sorted, b_sorted, b_orig, cand, tiles,
        (nt, CHUNK), [int(bool(exclude_self)),
                      splits or split_count(nt, w, sm_count(q_sorted.device))])


def refine_knn_straight(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    k: int,
    tiles: Opt = None,
    exclude_self: bool = False,
    boxes: Init = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K3b (see ``refine_knn_straight_reference`` for the contract).

    ``boxes``: the search grid's chunk boxes (``bbox_lo``, ``bbox_hi``),
    each (Pb / 256, 3) of the points' dtype, enclosing every record of
    their chunk. The kernel then skips a slot that every row of a tile is
    bounded away from; the result is the same with or without them.

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: float32 only, k <= 32, every tensor
    contiguous and on one device, and ``cand``/``tiles`` values must index
    chunks of ``b_sorted`` / tiles of ``q_sorted``. Each launch adds one to
    ``refine_knn_straight.launches``.
    """
    if boxes is not None:
        _check_boxes(boxes, b_sorted)
    if q_sorted.device.type == "cpu":
        return refine_knn_straight_reference(q_sorted, b_sorted, b_orig,
                                             cand, k, tiles, exclude_self)
    _check_k(k)
    return _launch_ungated(refine_knn_straight, q_sorted, b_sorted, b_orig,
                           cand, tiles, (cand.shape[0], CHUNK, k),
                           [k, int(bool(exclude_self))],
                           extra=boxes if boxes is not None else (None, None))


def occupancy(name: str) -> typing.Tuple[int, int]:
    """(registers a thread, resident blocks an SM) of the kernel ``name``
    (``refine_knn`` at one block a tile, ``refine_knn_straight``,
    ``knn_moments``, ``nn_brute``, ``knn_brute``, ``refine_nn_payload``,
    ``refine_nn_straight``, ``refine_nn_fused``, ``adaptive_refine`` or
    ``count_bbox``) on the current CUDA device, from the CUDA runtime."""
    from . import _build

    fn = getattr(_build.load(name).lib, f"pcc_{name}_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    rc = fn(ctypes.byref(regs), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy query failed ({rc})")
    return regs.value, blocks.value


refine_nn.launches = 0
refine_nn_payload.launches = 0
refine_knn.launches = 0
knn_moments.launches = 0
select_candidates.launches = 0
refine_nn_straight.launches = 0
refine_nn_fused.launches = 0
refine_knn_straight.launches = 0
