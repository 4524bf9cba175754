"""Exact brute-force k-nearest-neighbour search (small clouds).

Port of ``open_pcc_metric_tpu/ops/knn.py``, which the normal estimation
uses for clouds below the pruning threshold and for clouds with fewer than
k points (reference: open3d ``estimate_normals`` default 30-NN,
open_pcc_metric/cloud_pair.py:61-64). The JAX package runs it as plain XLA,
with no Pallas kernel; here it is plain PyTorch on any device.

Ties go to the lowest index: each query row's candidates are put in a total
(distance, index) order by a stable sort, which is the order the JAX
package's running top-k merge gives (``torch.topk`` promises no order among
ties).
"""
from __future__ import annotations

import typing

import torch

# Bounds one (query rows x search rows) distance block's element count.
_BLOCK_ELEMS = 1 << 24


def knn(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    k: int,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``a``, the ``k`` nearest rows of ``b``.

    Returns ``(idx int32 (Na, k), dist_sq (Na, k))``, ascending by
    distance, ties to the lower index. ``exclude_self`` gives row i of ``a``
    the largest finite distance to row i of ``b`` (``a`` is ``b``). ``k``
    must be <= Nb.
    """
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
