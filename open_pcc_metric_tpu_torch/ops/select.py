"""The fused select prologue: K2a (``select_bbox``) and K2b (``count_bbox``).

Port of ``open_pcc_metric_tpu/ops/select_pallas.py``. The pruned searches'
default prologue (``nn_pruned.tile_bounds``) materialises the whole (nta,
ncb) matrix of bbox lower bounds, sorts every row and counts entries under
each tile's threshold: work and memory that grow with N^2 while the refine
work per tile stays flat. Under ``prologue="select"`` these two kernels
compute the bounds on the fly and reduce them at once:

  * ``select_bbox`` (K2a, ``csrc/select_bbox.cu``): each query tile's
    ``cap`` lowest-bound search chunks, in ascending (rounded bound, chunk
    index) order, with the rounded-down bound of each; each key computed
    once into shared memory, a radix select that stops once the
    survivors fit ``survivor_room``, and a sort of the survivors in shared
    memory;
  * ``count_bbox`` (K2b, ``csrc/count_bbox.cu``): each tile's count of
    chunks whose rounded bound is at most its threshold, inflated by
    ``count_slack``; ``COUNT_TILES`` tiles a block over chunk boxes staged
    in shared memory, groups of 32 chunks skipped exactly by their box's
    bound, the chunk range split over a cluster of ``count_split`` blocks,
    the threshold inflated in the kernel.

Packed keys. A non-negative float32's bits order like the float, so the
bound's low ``key_bits(ncb_pad)`` mantissa bits are replaced by the chunk
index: ``key = (bits(lb) & ~low) | chunk``. Keys are unique, their order is
(rounded-down lb, chunk index), and one integer order gives both.

Soundness. Clearing low bits rounds a bound DOWN, so every count taken in
the rounded space over-counts the true-lb count. The certificates stay
sound as long as the stage-1 selection order, the probe counts and the
certificate counts all live in that one rounded space (the tiers of the
searches then work in true-lb space only), and ``count_slack`` inflates
each count threshold by four rounding buckets, so a count never falls
below the qualifying set of the selection, even if two computations of the
same bound differed by an ulp. Both kernels evaluate the bound with
``__fsub_rn/__fmul_rn/__fadd_rn`` and ``fmaxf`` in x, y, z order
(``pcc::bbox_lb``), the expression of ``grid.bbox_lower_bounds``, so on
the card and on the CPU the bound is the same float, bit for bit.

Each wrapper runs its plain PyTorch version (``*_reference``) on CPU
tensors and launches its kernel on CUDA tensors, or raises; each launch
adds one to its ``launches`` counter.
"""
from __future__ import annotations

import typing

import torch

from .grid import bbox_lower_bounds
from .refine import MAX_SPLITS, _check_splits, _launch, sm_count


def pad128(ncb: int) -> int:
    """The chunk count rounded up to 128 (the TPU kernel's lane padding),
    which sets the key width."""
    return (ncb + 127) // 128 * 128


def key_bits(ncb_pad: int) -> int:
    """Low-bit width of a packed key: enough to hold any chunk index."""
    return max(1, int(ncb_pad - 1).bit_length())


def mask_lb(lb: torch.Tensor, ncb_pad: int) -> torch.Tensor:
    """float32 bounds rounded DOWN to the key resolution (order kept)."""
    low = (1 << key_bits(ncb_pad)) - 1
    bits = lb.to(torch.float32).contiguous().view(torch.int32)
    return (bits & ~low).view(torch.float32)


def count_slack(ncb_pad: int) -> float:
    """Relative inflation of every count threshold: four rounding buckets,
    2^(bits - 21), so a count taken anywhere over-counts the select-space
    qualifying set (see ``select_pallas.count_slack`` for the argument)."""
    return float(2.0 ** (key_bits(ncb_pad) - 21))


def _check_boxes(a_lo, a_hi, b_lo, b_hi) -> typing.Tuple[int, int]:
    for name, x in (("a_lo", a_lo), ("a_hi", a_hi), ("b_lo", b_lo),
                    ("b_hi", b_hi)):
        if x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (n, 3); got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, not {x.dtype}")
    nta, ncb = a_lo.shape[0], b_lo.shape[0]
    if a_hi.shape[0] != nta or b_hi.shape[0] != ncb:
        raise ValueError("lo and hi corners differ in length")
    if ncb < 1:
        raise ValueError("the search cloud has no chunk")
    return nta, ncb


def _cuda_checks(name: str, tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def _keys(a_lo, a_hi, b_lo, b_hi) -> typing.Tuple[torch.Tensor, int]:
    """(nta, ncb) packed int32 keys of the materialised bounds, and the
    low-bit mask."""
    ncb = b_lo.shape[0]
    low = (1 << key_bits(pad128(ncb))) - 1
    lb = bbox_lower_bounds(a_lo, a_hi, b_lo, b_hi)
    cols = torch.arange(ncb, dtype=torch.int32, device=lb.device)
    return (lb.contiguous().view(torch.int32) & ~low) | cols, low


# ---------------------------------------------------------------- K2a

# K2a's shared-key design (csrc/select_bbox.cu): a row's keys and up to
# survivor_room(ncb, cap) survivors in shared memory, for rows of at most
# SHARED_MAX_CHUNKS chunks; wider rows take the first design, which
# recomputes the bounds in every pass. The kernel holds the same numbers.
SHARED_MAX_CHUNKS = 28672
MIN_ROOM = 256


def survivor_room(ncb: int, cap: int) -> int:
    """Survivors a shared-key row of K2a may hold before it sorts them."""
    return min(ncb, max(MIN_ROOM, 2 * cap))


def shared_bytes(ncb: int, cap: int) -> int:
    """K2a's dynamic shared bytes for a call of (ncb, cap); 0 when the rows
    are too wide for the shared-key design (chosen from ``ncb`` alone)."""
    if ncb > SHARED_MAX_CHUNKS:
        return 0
    return 4 * (ncb + survivor_room(ncb, cap))


def occupancy(ncb: int, cap: int) -> typing.Tuple[int, int, int]:
    """(registers a thread, resident blocks an SM, dynamic shared bytes) of
    the K2a kernel a call of (ncb, cap) launches, from the CUDA runtime on
    the current device."""
    import ctypes

    from . import _build

    fn = _build.load("select_bbox").lib.pcc_select_bbox_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    regs, blocks, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn(ncb, cap, ctypes.byref(regs), ctypes.byref(blocks),
            ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"select_bbox occupancy query failed ({rc})")
    return regs.value, blocks.value, smem.value


def select_bbox_reference(
    a_lo: torch.Tensor,
    a_hi: torch.Tensor,
    b_lo: torch.Tensor,
    b_hi: torch.Tensor,
    cap: int,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2a: ``(cand (nta, cap) int32, lb_sel (nta, cap)
    float32)``, each row the ``cap`` smallest packed keys of its tile,
    ascending. ``cand`` is the chunk index, ``lb_sel`` the rounded-down
    bound. Materialises the (nta, ncb) bounds, as the kernel does not."""
    _, ncb = _check_boxes(a_lo, a_hi, b_lo, b_hi)
    if not 1 <= cap <= ncb:
        raise ValueError(f"cap must be in [1, {ncb}], got {cap}")
    keys, low = _keys(a_lo, a_hi, b_lo, b_hi)
    keys = torch.sort(keys, dim=1).values[:, :cap]  # unique keys: no ties
    cand = torch.clamp(keys & low, max=ncb - 1)
    return cand, (keys & ~low).view(torch.float32)


def select_bbox(
    a_lo: torch.Tensor,
    a_hi: torch.Tensor,
    b_lo: torch.Tensor,
    b_hi: torch.Tensor,
    cap: int,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K2a (see ``select_bbox_reference`` for the contract): the ``cap``
    lowest-bound chunks of every query tile, never materialising the
    bounds. ``a_lo``/``a_hi`` are the (nta, 3) tile boxes, ``b_lo``/``b_hi``
    the (ncb, 3) chunk boxes, all float32; 1 <= cap <= ncb.

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: every tensor contiguous and on one
    device. Rows of at most ``SHARED_MAX_CHUNKS`` chunks take the
    shared-key design, wider ones the first (``shared_bytes``). Each launch
    adds one to ``select_bbox.launches``.
    """
    nta, ncb = _check_boxes(a_lo, a_hi, b_lo, b_hi)
    if not 1 <= cap <= ncb:
        raise ValueError(f"cap must be in [1, {ncb}], got {cap}")
    if a_lo.device.type == "cpu":
        return select_bbox_reference(a_lo, a_hi, b_lo, b_hi, cap)
    dev = _cuda_checks("select_bbox", [a_lo, a_hi, b_lo, b_hi])
    cand = torch.empty((nta, cap), dtype=torch.int32, device=dev)
    lb_sel = torch.empty((nta, cap), dtype=torch.float32, device=dev)
    if nta == 0:
        return cand, lb_sel
    _launch("select_bbox", dev, [a_lo, a_hi, b_lo, b_hi, cand, lb_sel],
            [nta, ncb, cap, key_bits(pad128(ncb))])
    select_bbox.launches += 1
    return cand, lb_sel


# ---------------------------------------------------------------- K2b

# K2b's query tiles a block (csrc/count_bbox.cu kTilesBlock: 8 warps of 4),
# and the fewest chunks a split of its chunk range is given.
COUNT_TILES = 32
MIN_SPLIT_CHUNKS = 256


def count_split(nta: int, ncb: int, sms: int) -> int:
    """K2b's blocks for each group of COUNT_TILES tiles, for ``nta`` tiles
    over ``ncb`` chunks on a device of ``sms`` SMs, from the shapes alone:
    enough to launch two blocks an SM, at most MAX_SPLITS and at most one
    per MIN_SPLIT_CHUNKS chunks. On an H100 (132 SMs): 3 at 800k a->b (104
    tile groups), 2 at 2M self (256)."""
    groups = -(-nta // COUNT_TILES)
    if groups <= 0:
        return 1
    want = -(-2 * sms // groups)
    return max(1, min(want, MAX_SPLITS, -(-ncb // MIN_SPLIT_CHUNKS)))


def inflate(thr: torch.Tensor, ncb: int) -> torch.Tensor:
    """The count threshold ``thr * (1 + count_slack)``, in float32. The
    factor is exact in float32, so this is one rounding of the product:
    the kernel's ``__fmul_rn(thr, factor)``."""
    return thr.to(torch.float32) * (1.0 + count_slack(pad128(ncb)))


def count_bbox_reference(
    a_lo: torch.Tensor,
    a_hi: torch.Tensor,
    b_lo: torch.Tensor,
    b_hi: torch.Tensor,
    thr: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch K2b: (nta,) int32 counts of chunks whose rounded bound
    is at most ``thr * (1 + count_slack)`` (``inflate``). Never below the
    true-lb count of chunks with lb <= thr."""
    nta, ncb = _check_boxes(a_lo, a_hi, b_lo, b_hi)
    if tuple(thr.shape) != (nta,):
        raise ValueError(f"thr must be ({nta},)")
    lb = bbox_lower_bounds(a_lo, a_hi, b_lo, b_hi)
    masked = mask_lb(lb, pad128(ncb))
    return (masked <= inflate(thr, ncb)[:, None]).sum(dim=1, dtype=torch.int32)


def count_bbox(
    a_lo: torch.Tensor,
    a_hi: torch.Tensor,
    b_lo: torch.Tensor,
    b_hi: torch.Tensor,
    thr: torch.Tensor,
    splits: typing.Optional[int] = None,
) -> torch.Tensor:
    """K2b (see ``count_bbox_reference`` for the contract). The kernel
    inflates ``thr`` itself, by the float32 factor ``1 + count_slack``.

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: every tensor contiguous and on one
    device. The chunk range is split over ``splits`` blocks of one cluster
    (default ``count_split``; a test argument, not a knob). Each launch
    adds one to ``count_bbox.launches``.
    """
    _check_splits(splits)
    nta, ncb = _check_boxes(a_lo, a_hi, b_lo, b_hi)
    if tuple(thr.shape) != (nta,):
        raise ValueError(f"thr must be ({nta},)")
    if a_lo.device.type == "cpu":
        return count_bbox_reference(a_lo, a_hi, b_lo, b_hi, thr)
    thr = thr.to(torch.float32).contiguous()
    dev = _cuda_checks("count_bbox", [a_lo, a_hi, b_lo, b_hi, thr])
    out = torch.empty(nta, dtype=torch.int32, device=dev)
    if nta == 0:
        return out
    _launch("count_bbox", dev, [a_lo, a_hi, b_lo, b_hi, thr, out],
            [nta, ncb, key_bits(pad128(ncb)),
             splits or count_split(nta, ncb, sm_count(dev)),
             1.0 + count_slack(pad128(ncb))])
    count_bbox.launches += 1
    return out


select_bbox.launches = 0
count_bbox.launches = 0
