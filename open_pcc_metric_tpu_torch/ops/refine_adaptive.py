"""K7: the adaptive schedule's 1-NN refine with expanded-norm distances.

Port of ``open_pcc_metric_tpu/ops/refine_adaptive.py``. The adaptive
schedule (``nn_pruned.nn_pruned_adaptive_sorted``) runs it three times per
sweep: a probe, a seeded gated extension and a seeded tail over the rest
of the tail tiles' lb orders. Queries and candidates come packed in the
JAX package's coordinate-major (8, P) layout, so tests hand both packages
the same arrays:

    qhat = [-2x, -2y, -2z, |q|^2, 1, 0, 0, 0]              (8, Pa)
    bhat = [x, y, z, 1, |b|^2, bitcast(original id), 0, 0]  (8, Pb)

and d = |q|^2 + |b|^2 - 2<q, b>, the sum the TPU kernel takes as one matrix
contraction. Every |coord| <= MXU_EXACT_MAX_COORD on an integer cloud
(``Cloud.mxu_exact``) makes every term an integer and d equal to the
difference form's bit for bit on valid rows; sentinel rows (1e9) are not
exact and are never compared. Callers gate on it (``nn_pruned_sorted``'s
``mxu_ok``).

On CUDA tensors ``adaptive_refine`` launches the hand-written kernel
``csrc/adaptive_refine.cu`` on the current stream (or raises); on CPU
tensors it runs ``adaptive_refine_reference``. The TPU kernel's 8-row
groups and 512-row calls are layout and are dropped: any number of rows
takes one launch. The kernel is K1's design (``csrc/pcc_nn.cuh``): each
row's live slots split over a thread-block cluster of
``refine.split_count`` blocks (8 for P3's few dozen tail tiles, 1 for the
probe's thousands) merged on chip by the lexicographic minimum, 8 chunks
staged a step, and a warp's 32-record word skipped when every row is
bounded away from its box by more than its best d and that best is below
2^22, where the expanded form's rounding cannot reorder the skipped
records. Neither changes a valid row.
"""
from __future__ import annotations

import typing

import torch

from .grid import CHUNK
from .refine import Init, _check_pair, _check_splits, _cuda_checks, \
    _expanded, _launch, _lexmin, sm_count, split_count, sq_norm
from .._layout_args import check_interpret


def pack_queries(points: torch.Tensor) -> torch.Tensor:
    """(8, Pa) augmented queries: [-2x, -2y, -2z, |q|^2, 1, 0, 0, 0]."""
    p = points.shape[0]
    one = points.new_ones(p)
    zero = points.new_zeros(p)
    x, y, z = points.unbind(dim=1)
    return torch.stack([-2.0 * x, -2.0 * y, -2.0 * z, sq_norm(points), one,
                        zero, zero, zero])


def pack_candidates(points: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(8, Pb) augmented candidates: [x, y, z, 1, |b|^2, bitcast(perm), 0,
    0]; float32 only (the id row carries int32 bits)."""
    if points.dtype != torch.float32:
        raise ValueError("the packed candidates are float32")
    p = points.shape[0]
    one = points.new_ones(p)
    zero = points.new_zeros(p)
    x, y, z = points.unbind(dim=1)
    ids = perm.to(torch.int32).contiguous().view(torch.float32)
    return torch.stack([x, y, z, one, sq_norm(points), ids, zero, zero])


def _check(qhat, bhat, cand, ncand, tids, init):
    for name, x in (("qhat", qhat), ("bhat", bhat)):
        if x.ndim != 2 or x.shape[0] != 8 or x.shape[1] % CHUNK:
            raise ValueError(f"{name} must be (8, P), P % {CHUNK} == 0; got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if cand.ndim != 2:
        raise ValueError(f"cand must be (rows, slots); got {tuple(cand.shape)}")
    rows = cand.shape[0]
    for name, x in (("cand", cand), ("ncand", ncand), ("tids", tids)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if name != "cand" and tuple(x.shape) != (rows,):
            raise ValueError(f"{name} must be ({rows},)")
    if init is not None:
        _check_pair("init", *init, (rows, CHUNK), torch.float32)


def adaptive_refine_reference(
    qhat: torch.Tensor,
    bhat: torch.Tensor,
    cand: torch.Tensor,
    ncand: torch.Tensor,
    tids: torch.Tensor,
    init: Init = None,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K7.

    Returns ((rows, 256) d, (rows, 256) original id): for query row r of
    tile ``tids[t]`` of ``qhat``, the lexicographic minimum of (d, id) over
    the columns of chunks ``cand[t, :ncand[t]]`` of ``bhat``, merged with
    ``init[t]``. d is the expanded-norm form (``refine._expanded``) over the
    packed rows; ``exclude_self`` drops the column whose global row equals
    the query's (tids[t] * 256 + lane).
    """
    _check(qhat, bhat, cand, ncand, tids, init)
    q4 = qhat[[0, 1, 2, 3]].t().contiguous()
    b4 = bhat[[0, 1, 2, 4]].t().contiguous()
    ids = bhat[5].contiguous().view(torch.int32)
    return _lexmin(q4, b4, ids, cand, tids, ncand, init, exclude_self,
                   _expanded)


def adaptive_refine(
    qhat: torch.Tensor,
    bhat: torch.Tensor,
    cand: torch.Tensor,
    ncand: torch.Tensor,
    tids: torch.Tensor,
    init: Init = None,
    exclude_self: bool = False,
    interpret: bool = False,
    *,
    splits: typing.Optional[int] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K7 (see ``adaptive_refine_reference`` for the contract).

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    the current stream, or raise: every tensor contiguous and on one
    device, ``cand`` values chunks of ``bhat`` and ``tids`` tiles of
    ``qhat``. The kernel fuses the multiply-adds, so it equals the plain
    version on the valid rows of clouds that pass ``Cloud.mxu_exact``. Each
    row's live slots are split over ``splits`` blocks of one cluster
    (``split_count(rows, slots, sm_count(device))`` when None; 1 forces one
    block a row), which changes no result: an argument for the tests and
    chip_smoke.py, not a knob. ``interpret`` is the JAX package's
    interpret-mode switch, checked and unused. Each launch adds one to
    ``adaptive_refine.launches``.
    """
    check_interpret(interpret)
    _check_splits(splits)
    if qhat.device.type == "cpu":
        return adaptive_refine_reference(qhat, bhat, cand, ncand, tids, init,
                                         exclude_self)
    _check(qhat, bhat, cand, ncand, tids, init)
    init_d, init_i = init if init is not None else (None, None)
    _cuda_checks("adaptive_refine", qhat,
                 [bhat, cand, ncand, tids, init_d, init_i])
    rows, slots = cand.shape
    dev = qhat.device
    out_d = torch.empty((rows, CHUNK), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, CHUNK), dtype=torch.int32, device=dev)
    if rows == 0:
        return out_d, out_i
    _launch("adaptive_refine", dev,
            [qhat, bhat, cand, ncand, tids, init_d, init_i, out_d, out_i],
            [rows, slots, qhat.shape[1], bhat.shape[1],
             int(bool(exclude_self)),
             splits or split_count(rows, slots, sm_count(dev))])
    adaptive_refine.launches += 1
    return out_d, out_i


adaptive_refine.launches = 0
