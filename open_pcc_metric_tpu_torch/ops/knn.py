"""Exact brute-force k-nearest-neighbour search (small clouds).

Port of ``open_pcc_metric_tpu/ops/knn.py``, which the normal estimation
uses for clouds below the pruning threshold and for clouds with fewer than
k points (reference: open3d ``estimate_normals`` default 30-NN,
open_pcc_metric/cloud_pair.py:61-64). The JAX package runs it as plain XLA,
with no Pallas kernel. Here:

  * ``knn_chunked``: the plain PyTorch version, on any device and float
    dtype (the CPU path, and the reference K8 is tested against).
  * ``knn``: ``knn_chunked`` on CPU tensors; on CUDA tensors K8, the
    brute-force k-NN kernel ``csrc/knn_brute.cu``, which takes float32 and
    k <= 32 (``refine.MAX_K``, as K3) only, and raises on anything else.

Ties go to the lowest index: each query row's candidates are put in a total
(distance, index) order by a stable sort, which is the order the JAX
package's running top-k merge gives (``torch.topk`` promises no order among
ties). K8 keeps the k smallest pairs of the same order, so both return the
same rows bit for bit.
"""
from __future__ import annotations

import typing

import torch

from .refine import _check_k, _launch
from .._layout_args import check_chunk

# Bounds one (query rows x search rows) distance block's element count.
_BLOCK_ELEMS = 1 << 24


def knn_chunked(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    k: int,
    exclude_self: bool = False,
    chunk_a: int = 256,
    chunk_b: int = 1024,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``a``, the ``k`` nearest rows of ``b``, in plain
    PyTorch.

    Returns ``(idx int32 (Na, k), dist_sq (Na, k))``, ascending by
    distance, ties to the lower index. ``exclude_self`` gives row i of ``a``
    the largest finite distance to row i of ``b`` (``a`` is ``b``). ``k``
    must be <= Nb. ``chunk_a``/``chunk_b`` are the JAX package's tile
    sizes, checked and unused: the distances go in blocks of
    ``_BLOCK_ELEMS`` elements here.
    """
    check_chunk("chunk_a", chunk_a)
    check_chunk("chunk_b", chunk_b)
    na, nb = a_points.shape[0], b_points.shape[0]
    if k > nb:
        raise ValueError(f"k={k} exceeds the {nb} search rows")
    big = torch.finfo(a_points.dtype).max
    rows = max(1, _BLOCK_ELEMS // max(1, nb))
    idx = torch.empty((na, k), dtype=torch.int32, device=a_points.device)
    dist = torch.empty((na, k), dtype=a_points.dtype, device=a_points.device)
    cols = torch.arange(nb, device=a_points.device)
    for s in range(0, na, rows):
        e = min(na, s + rows)
        d = None
        for c in range(3):
            diff = a_points[s:e, None, c] - b_points[None, :, c]
            sq = diff * diff
            d = sq if d is None else d + sq  # (rows, nb)
        if exclude_self:
            own = torch.arange(s, e, device=a_points.device)[:, None] == cols
            d = torch.where(own, big, d)
        dk, order = torch.sort(d, dim=1, stable=True)
        idx[s:e] = order[:, :k].to(torch.int32)
        dist[s:e] = dk[:, :k]
    return idx, dist


def knn(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    k: int,
    exclude_self: bool = False,
    chunk_a: int = 256,
    chunk_b: int = 1024,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``a``, the ``k`` nearest rows of ``b``: the contract
    of ``knn_chunked``.

    CPU tensors run ``knn_chunked``. CUDA tensors launch K8 on the current
    stream, with the same results bit for bit, or raise: the kernel takes
    (N, 3) float32 tensors on one device and 1 <= k <= 32. Each
    launch adds one to ``knn.launches``.
    """
    check_chunk("chunk_a", chunk_a)
    check_chunk("chunk_b", chunk_b)
    if a_points.device.type == "cpu":
        return knn_chunked(a_points, b_points, k, exclude_self)
    if a_points.device.type != "cuda":
        raise ValueError(f"knn runs on cpu or cuda, not {a_points.device}")
    for name, x in (("a_points", a_points), ("b_points", b_points)):
        if x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3), got {tuple(x.shape)}")
    if b_points.device != a_points.device or b_points.dtype != a_points.dtype:
        raise ValueError("a_points and b_points must share one dtype and device")
    if a_points.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, not {a_points.dtype}")
    na, nb = a_points.shape[0], b_points.shape[0]
    _check_k(k)  # K8 holds one slot of a row's list a lane, as K3 does
    if k > nb:
        raise ValueError(f"k={k} exceeds the {nb} search rows")
    dev = a_points.device
    idx = torch.empty((na, k), dtype=torch.int32, device=dev)
    dist = torch.empty((na, k), dtype=torch.float32, device=dev)
    if na == 0:
        return idx, dist
    _launch("knn_brute", dev,
            [a_points.contiguous(), b_points.contiguous(), dist, idx],
            [na, nb, k, int(bool(exclude_self))])
    knn.launches += 1
    return idx, dist


knn.launches = 0
