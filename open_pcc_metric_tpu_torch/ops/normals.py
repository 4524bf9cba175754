"""PCA normal estimation (k-NN covariance + closed-form 3x3 eigh).

Port of ``open_pcc_metric_tpu/ops/normals.py``. Replaces the reference's
``PointCloud.estimate_normals()`` with Open3D's defaults (reference:
open_pcc_metric/cloud_pair.py:61-64; ``KDTreeSearchParamKNN(knn=30)``): for
every point, the covariance of its 30 nearest neighbours (the point itself
included, population normalisation) and the eigenvector of the smallest
eigenvalue. Normals are unoriented (sign arbitrary) like the reference's:
D2 squares the projection, so the sign cancels.

Large clouds go through the pruned k-NN with in-kernel moment sums
(``knn_pruned_sorted(with_moments=True)``: kernels K3 and K4); clouds below
the pruning threshold, and clouds with fewer than k points, through the
brute-force k-NN and a neighbour gather.
"""
from __future__ import annotations

import os
import typing

import torch

from .eigh3 import smallest_eigenvector_components, smallest_eigenvector_sym3
from .grid import CHUNK
from ..utils.cache import climb
from ..utils.profiling import span, spanned

DEFAULT_KNN = 30

# At or above this many padded rows the Morton-grid pruned k-NN takes over
# from the brute-force one (the JAX package's value).
_PRUNE_THRESHOLD = 65536


def cov3(centered: torch.Tensor) -> torch.Tensor:
    """(P, k, 3) centred neighbourhoods -> (P, 3, 3) covariance sums.

    Elementwise products, not an einsum: a matmul may run in TF32 on the
    card, enough covariance noise to tilt PCA normals visibly (the JAX
    package found the same with the TPU's bfloat16 matrix unit).
    """
    c0, c1, c2 = centered[..., 0], centered[..., 1], centered[..., 2]
    s00 = (c0 * c0).sum(dim=-1)
    s11 = (c1 * c1).sum(dim=-1)
    s22 = (c2 * c2).sum(dim=-1)
    s01 = (c0 * c1).sum(dim=-1)
    s02 = (c0 * c2).sum(dim=-1)
    s12 = (c1 * c2).sum(dim=-1)
    row0 = torch.stack([s00, s01, s02], dim=-1)
    row1 = torch.stack([s01, s11, s12], dim=-1)
    row2 = torch.stack([s02, s12, s22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def normals_from_neighbors(
    points: torch.Tensor,
    neighbor_idx: torch.Tensor,
    k: int,
    n_valid: typing.Optional[int] = None,
) -> torch.Tensor:
    """Covariance PCA normal from given neighbour index lists (P, k).

    Neighbour slots pointing at padded rows (idx >= n_valid, possible when
    the cloud has fewer than k points, where FLANN would return fewer
    neighbours) are left out of the covariance.
    """
    neigh = points[neighbor_idx.long()]  # (P, k, 3)
    if n_valid is not None:
        w = (neighbor_idx < n_valid)[:, :, None].to(points.dtype)
        cnt = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
        mean = (neigh * w).sum(dim=1, keepdim=True) / cnt
        centered = (neigh - mean) * w
        cov = cov3(centered) / cnt[..., 0][..., None]
    else:
        mean = neigh.mean(dim=1, keepdim=True)
        centered = neigh - mean
        # Population covariance (divide by k), as Open3D's cumulants.
        cov = cov3(centered) / torch.tensor(float(k), dtype=points.dtype,
                                            device=points.device)
    return smallest_eigenvector_sym3(cov)


def normals_from_moments(mom: torch.Tensor) -> torch.Tensor:
    """PCA normal from per-query k-NN moment sums (P, MOM_CH).

    ``mom`` rows are [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz] of the
    query-relative neighbour offsets (``refine.knn_moments``). Covariance
    by central moments, cov = S2/cnt - m1 m1^T, with no cancellation since
    the offsets are centred on the query. Matches
    ``normals_from_neighbors`` up to summation order.
    """
    cnt = torch.clamp(mom[:, 0], min=1.0)[:, None]
    m1 = mom[:, 1:4] / cnt  # mean offset
    s2 = mom[:, 4:10] / cnt  # [xx, yy, zz, xy, xz, yz]
    return smallest_eigenvector_components(
        s2[:, 0] - m1[:, 0] * m1[:, 0],
        s2[:, 1] - m1[:, 1] * m1[:, 1],
        s2[:, 2] - m1[:, 2] * m1[:, 2],
        s2[:, 3] - m1[:, 0] * m1[:, 1],
        s2[:, 4] - m1[:, 0] * m1[:, 2],
        s2[:, 5] - m1[:, 1] * m1[:, 2],
    )


@spanned("pcc.estimate")
def estimate_normals(
    points: torch.Tensor,
    k: int = DEFAULT_KNN,
    neighbor_idx: typing.Optional[torch.Tensor] = None,
    n_valid: typing.Optional[int] = None,
) -> torch.Tensor:
    """Unit normals for a padded (P, 3) point array.

    The k-NN search runs over the same cloud with each point in its own
    neighbourhood (FLANN/Open3D semantics). Clouds of ``_PRUNE_THRESHOLD``
    padded rows or more go through the pruned k-NN. Padded rows get the
    degenerate fallback normal; callers mask rows >= n.
    """
    if neighbor_idx is None:
        if points.shape[0] >= _PRUNE_THRESHOLD:
            from .knn_pruned import knn_pruned

            n = n_valid if n_valid is not None else points.shape[0]
            neighbor_idx, _ = knn_pruned(points, points, n, n, k=k)
        else:
            from .knn import knn

            neighbor_idx, _ = knn(points, points, k=k, exclude_self=False)
    return normals_from_neighbors(points, neighbor_idx, k, n_valid=n_valid)


@spanned("pcc.estimate")
def estimation_core(g, n: int, k: int, cap: int, ft: int, flags=None):
    """Estimation over a prebuilt grid, one certificate rung, with the
    pruned k-NN's schedule ``flags`` (``knn_pruned.KnnFlags``;
    ``knn_flags_from_env()`` read at this call when None: its prologue and
    stage-1 schedule among them).

    Normals come straight from the in-kernel moment sums; only the (P, 3)
    normals are unsorted. The k-NN includes each point itself, so slot 1 is
    its nearest other point: the intra-cloud boundary stats (reference
    compute_nearest_neighbor_distance, cloud_pair.py:108-109) come for free.
    Nothing is read back to the host: ``overflow`` stays a device tensor.

    Returns ``(normals in original row order, normals in sorted order, mn,
    mx, overflow)``, the JAX package's tuple; the caller owns the
    escalation on ``overflow``.
    """
    from .knn_pruned import knn_pruned_sorted
    from .nn_pruned import unsort_rows

    dk, _, overflow, mom = knn_pruned_sorted(
        g, g, n, k, cap=cap, fallback_tiles=ft, with_moments=True,
        flags=flags)
    valid = torch.arange(g.perm.shape[0], device=dk.device) < n
    d1 = torch.sqrt(torch.clamp(dk[:, min(k - 1, 1)], min=0.0))
    mn = torch.where(valid, d1, torch.inf).amin()
    mx = torch.where(valid, d1, -torch.inf).amax()
    nrm_sorted = normals_from_moments(mom)
    return unsort_rows(g, nrm_sorted), nrm_sorted, mn, mx, overflow


# Certified (cap, fallback_tiles) rung per (padded size, k): same-shaped
# clouds of a sweep skip the rungs that already failed; ladder_lookup
# retries the base rung now and then. Both k-NN schedules refine every
# chunk a certified tile needs and all ``cap`` of the others, so they
# overflow on the same rungs and share it.
_LADDER_MEMO: dict = {}
KNN_CAP_ENV, KNN_FT_ENV = "PCC_KNN_CAP", "PCC_KNN_FT"


def knn_base_rung(cap: typing.Optional[int] = None,
                  fallback_tiles: typing.Optional[int] = None):
    """The estimation ladder's base rung: each of ``cap`` and
    ``fallback_tiles`` when given, else ``PCC_KNN_CAP`` / ``PCC_KNN_FT``
    read at this call (64 and 256 when unset)."""
    return (int(os.environ.get(KNN_CAP_ENV, "64")) if cap is None else cap,
            int(os.environ.get(KNN_FT_ENV, "256")) if fallback_tiles is None
            else fallback_tiles)


def estimate_normals_cloud(cloud, k: int = DEFAULT_KNN, *,
                           cap: typing.Optional[int] = None,
                           fallback_tiles: typing.Optional[int] = None,
                           prologue: typing.Optional[str] = None,
                           sched: typing.Optional[str] = None
                           ) -> torch.Tensor:
    """Estimate normals reusing the Cloud's cached Morton grid.

    ``(cap, fallback_tiles)`` is the base rung of the certificate ladder
    (``knn_base_rung``). Small clouds take the brute-force k-NN; so do
    clouds with fewer than k valid points, whose moments would count
    sentinel rows into the k-set where the brute path masks them (FLANN's
    "fewer neighbours"). The schedule is ``knn_flags_from_env()`` read at
    this call, with ``prologue`` and ``sched`` in place of its own when
    given. The boundary stats that fall out of the pruned pass are cached
    on the cloud when none are set, and so are the sorted normals at the
    default k, as the JAX package caches them.
    """
    p = cloud.padded_size
    n = int(cloud.n)
    if p < _PRUNE_THRESHOLD or n < k:
        return estimate_normals(cloud.points, k=k, n_valid=n)
    from .knn_pruned import resolve_knn_flags

    flags = resolve_knn_flags(prologue=prologue, sched=sched)
    g = cloud.get_grid()

    def run(cap, fallback):
        *out, overflow = estimation_core(g, n, k, cap, fallback, flags)
        with span("pcc.readback"):
            overflow = bool(overflow)
        return out, overflow

    (nrm, nrm_sorted, mn, mx), _ = climb(
        run, knn_base_rung(cap, fallback_tiles), g.n_chunks, p // CHUNK,
        _LADDER_MEMO, (p, k))
    if k >= 2 and n >= 2 and cloud._boundary_stats is None:
        cloud._boundary_stats = (mn, mx)
    # Only default-k normals may feed the sorted-normals cache that the
    # pair sweeps read.
    if k == DEFAULT_KNN and cloud._sorted_normals is None:
        cloud._sorted_normals = nrm_sorted
    return nrm
