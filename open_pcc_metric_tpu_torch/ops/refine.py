"""The refine kernels: K1 (1-NN), K3 (k-NN) and K4 (k-NN moment sums).

Each refines 256-query tiles over candidate chunks of a Morton grid:

  * ``refine_nn`` (K1) keeps the lexicographic (d, original id) minimum:
    every pruned 1-NN pass (probe, gated extension, both certificate tiers,
    cross and self) runs it. Kernel ``csrc/refine_nn.cu``, the port of
    ``refine_pallas.py`` ``refine_nn_pallas_t``.
  * ``refine_knn`` (K3) keeps the k lexicographically smallest pairs: the
    pruned k-NN of the normal estimation runs it. Kernel
    ``csrc/refine_knn.cu``, the port of ``refine_knn_pallas_t``.
  * ``knn_moments`` (K4) sums the query-relative offsets of each query's
    exact k-NN set: the normals come from these sums. Kernel
    ``csrc/knn_moments.cu``, the port of ``moments_pallas_t``.

On CUDA tensors each wrapper launches its hand-written kernel on the
current stream (or raises); on CPU tensors it runs its plain PyTorch
version (``*_reference``), which is also what the kernel is checked against
on the card. All three compute the squared distance as ((dx^2 + dy^2) +
dz^2) with dx = b - q, each step rounded on its own, so K4's membership
test sees the distances K3 kept.
"""
from __future__ import annotations

import ctypes
import typing

import torch

from .grid import CHUNK

INT_MAX = torch.iinfo(torch.int32).max
MOM_CH = 10  # [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz]
MAX_K = 32  # the largest k one K3 build serves

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


def _blocks(q_sorted, b_sorted, b_orig, cand, tiles, row_elems):
    """Batches of tiles for the plain versions: yields (s, e, q, pts, ids,
    t, c) with q (n, 256, 3) the queries, pts (n, 1, w*256, 3) and ids
    (n, 1, w*256) the candidates, t and c the tile and chunk ids (int64)."""
    nt, w = cand.shape
    q_tiles = q_sorted.reshape(-1, CHUNK, 3)
    b_chunks = b_sorted.reshape(-1, CHUNK, 3)
    o_chunks = b_orig.reshape(-1, CHUNK)
    if tiles is None:
        tiles = torch.arange(nt, dtype=torch.int32, device=q_sorted.device)
    bt = max(1, _REF_BLOCK_ELEMS // max(1, row_elems * CHUNK))
    for s in range(0, nt, bt):
        e = min(nt, s + bt)
        t, c = tiles[s:e].long(), cand[s:e].long()
        n = e - s
        yield (s, e, q_tiles[t], b_chunks[c].reshape(n, 1, w * CHUNK, 3),
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
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1, on any device and float dtype.

    Returns ((nt, 256) min squared distance, (nt, 256) original id): for
    query row r of tile ``tiles[t]`` (default t), the lexicographic minimum
    of (d, b_orig[col]) over the columns of chunks ``cand[t, :ncand[t]]``
    (all of ``cand[t]`` when ncand is None), merged with ``init[t]``. The
    distance sums (b - q)^2 over x, y, z in that order. Works over batches
    of tiles, like the JAX package's ``refine_xla``.
    """
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand)
    nt, w = cand.shape
    if init is not None:
        _check_pair("init", *init, (nt, CHUNK), q_sorted.dtype)
    dev = q_sorted.device
    out_d = torch.empty((nt, CHUNK), dtype=q_sorted.dtype, device=dev)
    out_i = torch.empty((nt, CHUNK), dtype=torch.int32, device=dev)
    for s, e, q, pts, ids, t, c in _blocks(q_sorted, b_sorted, b_orig, cand,
                                           tiles, w * CHUNK):
        d = _offsets(q, pts)[3]
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


# ---------------------------------------------------------------- K3


def _extract_k(d: torch.Tensor, ids: torch.Tensor, k: int):
    """k rounds of (lexicographic minimum, mask it out) over the last axis:
    the ascending k smallest distinct (d, id) pairs. Masked entries become
    (inf, INT_MAX), so a row with fewer than k finite pairs ends in
    (inf, INT_MAX). The port of the JAX package's ``_extract_k``."""
    out_d = d.new_empty(d.shape[:-1] + (k,))
    out_i = ids.new_empty(ids.shape[:-1] + (k,))
    for r in range(k):
        m = d.amin(dim=-1, keepdim=True)
        at_min = d == m
        ii = torch.where(at_min, ids, INT_MAX).amin(dim=-1, keepdim=True)
        hit = at_min & (ids == ii)
        d = d.masked_fill(hit, torch.inf)
        ids = ids.masked_fill(hit, INT_MAX)
        out_d[..., r] = m[..., 0]
        out_i[..., r] = ii[..., 0]
    return out_d, out_i


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


# ---------------------------------------------------------------- launches

# name -> (C entry, number of pointer arguments, number of int arguments)
_ENTRIES = {
    "refine_nn": ("pcc_refine_nn", 10, 3),
    "refine_knn": ("pcc_refine_knn", 10, 4),
    "knn_moments": ("pcc_knn_moments", 10, 2),
}


def _ptr(x: Opt):
    return None if x is None else x.data_ptr()


def _entry(name: str):
    """The bound C entry of kernel ``name`` and its library."""
    from . import _build

    lib = _build.load(name).lib
    symbol, n_ptr, n_int = _ENTRIES[name]
    fn = getattr(lib, symbol)
    if not getattr(lib, "_pcc_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
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


def _launch(name: str, device: torch.device, ptrs, ints) -> None:
    fn, lib = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[_ptr(x) for x in ptrs], *ints, stream)
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
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K1 (see ``refine_nn_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: the kernel takes float32 only, every
    tensor contiguous and on one device, and ``cand``/``tiles`` values must
    index chunks of ``b_sorted`` / tiles of ``q_sorted``. Each launch adds
    one to ``refine_nn.launches``.
    """
    if q_sorted.device.type == "cpu":
        return refine_nn_reference(q_sorted, b_sorted, b_orig, cand, tiles,
                                   ncand, init, exclude_self)
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
             out_d, out_i], [nt, w, int(bool(exclude_self))])
    refine_nn.launches += 1
    return out_d, out_i


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
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K3 (see ``refine_knn_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: the kernel takes float32 only, k <= 32,
    every tensor contiguous and on one device, and ``cand``/``tiles``
    values must index chunks of ``b_sorted`` / tiles of ``q_sorted``. Each
    launch adds one to ``refine_knn.launches``.
    """
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
             out_d, out_i], [nt, w, k, int(bool(exclude_self))])
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
) -> torch.Tensor:
    """K4 (see ``knn_moments_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: the kernel takes float32 only, every
    tensor contiguous and on one device, and ``cand``/``tiles`` values must
    index chunks of ``b_sorted`` / tiles of ``q_sorted``. Each launch adds
    one to ``knn_moments.launches``.
    """
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
    _cuda_checks("knn_moments", q_sorted,
                 [b_sorted, b_orig, cand, tiles, ncand, rk, ik, init])
    if init is not None and init.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, not {init.dtype}")
    out = torch.empty((nt, CHUNK, MOM_CH), dtype=torch.float32,
                      device=q_sorted.device)
    if nt == 0:
        return out
    _launch("knn_moments", q_sorted.device,
            [q_sorted, b_sorted, b_orig, cand, tiles, ncand, rk, ik, init,
             out], [nt, w])
    knn_moments.launches += 1
    return out


refine_nn.launches = 0
refine_knn.launches = 0
knn_moments.launches = 0
