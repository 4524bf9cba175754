"""K1: 1-NN refine of 256-query tiles over candidate chunks.

``refine_nn`` is the one refine every pruned-NN pass runs: the probe, the
gated extension and both certificate tiers, cross and self. On CUDA tensors
it launches the hand-written kernel ``csrc/refine_nn.cu`` (the port of
``open_pcc_metric_tpu/ops/refine_pallas.py`` ``refine_nn_pallas_t``); on CPU
tensors it runs ``refine_nn_reference``, the plain PyTorch version, which is
also what the kernel is checked against on the card.
"""
from __future__ import annotations

import ctypes
import typing

import torch

from .grid import CHUNK

INT_MAX = torch.iinfo(torch.int32).max

# The plain version materialises (tiles, 256, slots * 256) distance blocks;
# this bounds one block's element count (64 MB of float32).
_REF_BLOCK_ELEMS = 1 << 24

Init = typing.Optional[typing.Tuple[torch.Tensor, torch.Tensor]]


def _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand, init):
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
    if init is not None:
        d0, i0 = init
        if tuple(d0.shape) != (nt, CHUNK) or tuple(i0.shape) != (nt, CHUNK):
            raise ValueError(f"init must be two ({nt}, {CHUNK}) tensors")
        if d0.dtype != q_sorted.dtype or i0.dtype != torch.int32:
            raise ValueError("init must be (points dtype, int32)")


def refine_nn_reference(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    tiles: typing.Optional[torch.Tensor] = None,
    ncand: typing.Optional[torch.Tensor] = None,
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
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand, init)
    dev = q_sorted.device
    nt, w = cand.shape
    q_tiles = q_sorted.reshape(-1, CHUNK, 3)
    b_chunks = b_sorted.reshape(-1, CHUNK, 3)
    o_chunks = b_orig.reshape(-1, CHUNK)
    if tiles is None:
        tiles = torch.arange(nt, dtype=torch.int32, device=dev)
    lane = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    slot = torch.arange(w, dtype=torch.int32, device=dev)
    out_d = torch.empty((nt, CHUNK), dtype=q_sorted.dtype, device=dev)
    out_i = torch.empty((nt, CHUNK), dtype=torch.int32, device=dev)
    bt = max(1, _REF_BLOCK_ELEMS // max(1, w * CHUNK * CHUNK))
    for s in range(0, nt, bt):
        e = min(nt, s + bt)
        t, c = tiles[s:e].long(), cand[s:e].long()
        n = e - s
        q = q_tiles[t]  # (n, 256, 3)
        pts = b_chunks[c].reshape(n, 1, w * CHUNK, 3)
        d = None
        for k in range(3):
            diff = pts[..., k] - q[:, :, None, k]
            sq = diff * diff
            d = sq if d is None else d + sq  # (n, 256, w*256)
        ids = o_chunks[c].reshape(n, 1, w * CHUNK)
        if ncand is not None:
            live = (slot[None, :] < ncand[s:e, None]).repeat_interleave(
                CHUNK, dim=1)[:, None, :]
            d = torch.where(live, d, torch.inf)
            ids = torch.where(live, ids, INT_MAX)
        if exclude_self:
            gcol = (c[:, :, None] * CHUNK + lane).reshape(n, 1, w * CHUNK)
            grow = (t[:, None] * CHUNK + lane)[:, :, None]
            d = torch.where(grow == gcol, torch.inf, d)
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


def _ptr(x: typing.Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _kernel_lib():
    from . import _build

    lib = _build.load("refine_nn").lib
    if not getattr(lib, "_pcc_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pcc_refine_nn.argtypes = [p] * 10 + [i, i, i, p]
        lib.pcc_refine_nn.restype = ctypes.c_int
        lib.pcc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pcc_cuda_error_string.restype = ctypes.c_char_p
        lib._pcc_bound = True
    return lib


def refine_nn(
    q_sorted: torch.Tensor,
    b_sorted: torch.Tensor,
    b_orig: torch.Tensor,
    cand: torch.Tensor,
    tiles: typing.Optional[torch.Tensor] = None,
    ncand: typing.Optional[torch.Tensor] = None,
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
    if q_sorted.device.type != "cuda":
        raise ValueError(f"refine_nn runs on cpu or cuda, not {q_sorted.device}")
    _check(q_sorted, b_sorted, b_orig, cand, tiles, ncand, init)
    tensors = [q_sorted, b_sorted, b_orig, cand, tiles, ncand]
    tensors += list(init) if init is not None else []
    for x in tensors:
        if x is None:
            continue
        if x.device != q_sorted.device:
            raise ValueError("refine_nn: all tensors must be on one device")
        if not x.is_contiguous():
            raise ValueError("refine_nn: tensors must be contiguous")
    if q_sorted.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, not {q_sorted.dtype}")
    nt, w = cand.shape
    out_d = torch.empty((nt, CHUNK), dtype=torch.float32, device=q_sorted.device)
    out_i = torch.empty((nt, CHUNK), dtype=torch.int32, device=q_sorted.device)
    if nt == 0:
        return out_d, out_i
    lib = _kernel_lib()
    with torch.cuda.device(q_sorted.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pcc_refine_nn(
            _ptr(q_sorted), _ptr(b_sorted), _ptr(b_orig), _ptr(cand),
            _ptr(tiles), _ptr(ncand),
            _ptr(init[0]) if init is not None else None,
            _ptr(init[1]) if init is not None else None,
            _ptr(out_d), _ptr(out_i), nt, w, int(bool(exclude_self)), stream,
        )
    if rc != 0:
        msg = lib.pcc_cuda_error_string(rc).decode()
        raise RuntimeError(f"refine_nn kernel launch failed: {msg} ({rc})")
    refine_nn.launches += 1
    return out_d, out_i


refine_nn.launches = 0
