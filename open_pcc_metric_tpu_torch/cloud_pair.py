"""CloudPair: the geometry state shared by all metrics of one (origin,
reconst) pair.

Port of ``open_pcc_metric_tpu/cloud_pair.py`` (reference
open_pcc_metric/cloud_pair.py:45-124). Every derived quantity is computed
lazily on the clouds' device and cached: nothing runs unless a requested
metric needs it.

  * bidirectional 1-NN: ``ops/nn.nearest_neighbors`` — the brute force
    (K5) below ``PRUNE_THRESHOLD`` padded rows, the pruned search over the
    clouds' cached Morton grids (K1) at or above it;
  * normals: the file's, else the cloud's cached 30-NN PCA estimate;
  * intra-origin NN distances: the same search with ``exclude_self``
    (reference compute_nearest_neighbor_distance, cloud_pair.py:108-109);
  * minimal-OBB extent of the origin (reference cloud_pair.py:111-112).

Accessors return valid-length tensors (padding sliced off), so the metric
formulas need no masking. Neighbour distances are SQUARED, boundary
(intra-cloud) distances plain Euclidean, as in the reference (SURVEY Q6).
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from .cloud import Cloud
from .ops import nn as nn_ops
from .ops import normals as normal_ops

# How the D2 (point-to-plane) projection picks its normals:
#   "reference": the OPPOSITE cloud's normals indexed POSITIONALLY by the
#       iterating point's index — the reference's quirk (reference:
#       metric.py:130 + 146-153, SURVEY Q3). Requires n_iter <= n_other.
#   "pc_error": the normal of the actual nearest neighbour in the other cloud
#       (MPEG pc_error convention).
D2_MODES = ("reference", "pc_error")


class CloudPair:
    def __init__(
        self,
        origin_cloud: Cloud,
        reconst_cloud: Cloud,
        backend: str = "auto",
        knn_normals: int = normal_ops.DEFAULT_KNN,
    ):
        nn_ops.resolve_backend(backend, 0)  # rejects unknown names now
        self.clouds: typing.Tuple[Cloud, Cloud] = (origin_cloud, reconst_cloud)
        self._backend = backend
        self._knn_normals = knn_normals
        self._nn_cache: dict = {}
        self._normals_cache: dict = {}
        self._boundary_cache: typing.Optional[torch.Tensor] = None

    def _use_pruned(self, a: Cloud, b: Cloud) -> bool:
        rows = max(a.padded_size, b.padded_size)
        return nn_ops.resolve_backend(self._backend, rows) == "pruned"

    def _search(self, a: Cloud, b: Cloud, exclude_self: bool = False):
        """Padded ``(idx, dist_sq)`` of ``a``'s rows into ``b``; the pruned
        search reuses the clouds' cached grids."""
        if self._use_pruned(a, b):
            return nn_ops.nearest_neighbors(
                a.points, b.points, exclude_self=exclude_self,
                backend="pruned", n_a=a.n, n_b=b.n,
                grids=(a.get_grid(), b.get_grid()))
        return nn_ops.nearest_neighbors(
            a.points, b.points, exclude_self=exclude_self, backend="brute")

    # ------------------------------------------------------------ core state

    @property
    def origin_cloud(self) -> Cloud:
        return self.clouds[0]

    @property
    def reconst_cloud(self) -> Cloud:
        return self.clouds[1]

    def _nn(self, direction: int) -> typing.Tuple[torch.Tensor, torch.Tensor]:
        """Padded ``(idx, dist_sq)`` 1-NN of clouds[direction] into the
        other cloud; cached after first use."""
        if direction not in self._nn_cache:
            self._nn_cache[direction] = self._search(
                self.clouds[direction], self.clouds[1 - direction])
        return self._nn_cache[direction]

    def _normals(self, index: int) -> torch.Tensor:
        """Padded normals of clouds[index]; estimated if the file had none."""
        if index not in self._normals_cache:
            c = self.clouds[index]
            if c.has_normals():
                self._normals_cache[index] = c.normals
            elif self._knn_normals == normal_ops.DEFAULT_KNN:
                # Cloud-level cache: estimated normals depend only on the
                # cloud and are reused across pairs (QP sweeps).
                self._normals_cache[index] = c.get_normals()
            else:
                self._normals_cache[index] = normal_ops.estimate_normals_cloud(
                    c, k=self._knn_normals)
        return self._normals_cache[index]

    # ----------------------------------------------------- reference surface
    # (method-for-method parity with reference cloud_pair.py:82-124)

    def get_left_error_vector(self) -> torch.Tensor:
        return self._error_vector(0)

    def get_right_error_vector(self) -> torch.Tensor:
        return self._error_vector(1)

    def _error_vector(self, direction: int) -> torch.Tensor:
        a = self.clouds[direction]
        b = self.clouds[1 - direction]
        idx, _ = self._nn(direction)
        return (a.points - b.points[idx.long()])[: a.n]

    def get_left_neighbour_distances(self) -> torch.Tensor:
        return self._nn(0)[1][: self.clouds[0].n]

    def get_right_neighbour_distances(self) -> torch.Tensor:
        return self._nn(1)[1][: self.clouds[1].n]

    def get_boundary_sqrt_distances(self) -> torch.Tensor:
        """Intra-origin plain (non-squared) NN distances (SURVEY Q6).

        Raises ValueError for a single-point origin cloud: a self-excluded
        nearest neighbour does not exist there.
        """
        if self._boundary_cache is None:
            c = self.clouds[0]
            if int(c.n) < 2:
                raise ValueError(
                    "intra-cloud NN distances need at least 2 points; the "
                    f"origin cloud has {int(c.n)}"
                )
            _, d = self._search(c, c, exclude_self=True)
            self._boundary_cache = torch.sqrt(d[: c.n])
        return self._boundary_cache

    def get_extent(self) -> np.ndarray:
        """Minimal-OBB extent of the ORIGIN cloud only (SURVEY Q4)."""
        return self.clouds[0].get_obb_extent()

    def get_left_colors(self) -> torch.Tensor:
        return self._colors(0)

    def get_right_colors(self) -> torch.Tensor:
        return self._colors(1)

    def _colors(self, index: int) -> torch.Tensor:
        c = self.clouds[index]
        if c.colors is None:
            raise ValueError(f"cloud {index} has no colors")
        return c.colors[: c.n]

    def get_left_neighbour_colors(self) -> torch.Tensor:
        return self._neighbour_colors(0)

    def get_right_neighbour_colors(self) -> torch.Tensor:
        return self._neighbour_colors(1)

    def _neighbour_colors(self, direction: int) -> torch.Tensor:
        a = self.clouds[direction]
        b = self.clouds[1 - direction]
        if b.colors is None:
            raise ValueError(f"cloud {1 - direction} has no colors")
        idx, _ = self._nn(direction)
        return b.colors[idx.long()][: a.n]

    # ----------------------------------------------------------- D2 plumbing

    def get_cloud_normals(self, index: int) -> torch.Tensor:
        """Valid-length normals of clouds[index] (reference: metric.py:92-98)."""
        return self._normals(index)[: self.clouds[index].n]

    def get_neighbour_normals(self, direction: int) -> torch.Tensor:
        """Normals of each point's actual NN in the other cloud (pc_error D2)."""
        a = self.clouds[direction]
        idx, _ = self._nn(direction)
        return self._normals(1 - direction)[idx.long()][: a.n]


def get_neighbour_cloud(
    iter_cloud: Cloud,
    search_cloud: Cloud,
    n: int = 0,
) -> typing.Tuple[Cloud, np.ndarray]:
    """n-th nearest neighbour cloud, generalising the reference helper.

    Parity surface for the reference's ``get_neighbour_cloud(iter_cloud,
    search_cloud, kdtree, n)`` (reference cloud_pair.py:10-42): for every
    point of ``iter_cloud``, its (n+1)-th nearest neighbour in
    ``search_cloud``. Returns ``(neighbour Cloud with colours when the
    search cloud has them, float64 squared distances)``; the Cloud lives on
    the iterating cloud's device. n = 0 goes through the 1-NN engines
    (lowest original index on ties), n > 0 through the exact k-NN engines
    with k = n + 1. On CUDA tensors n <= 31: both k-NN kernels (K3 on the
    pruned path, K8 below it) take k <= 32 and raise above it.
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    a, b = iter_cloud, search_cloud
    if n == 0:
        idx, d = nn_ops.nearest_neighbors(a.points, b.points, n_a=a.n,
                                          n_b=b.n)
        idx, d = idx[: a.n], d[: a.n]
    else:
        k = n + 1
        if max(a.padded_size, b.padded_size) >= nn_ops.PRUNE_THRESHOLD:
            from .ops.knn_pruned import knn_pruned

            idx_k, d_k = knn_pruned(a.points, b.points, a.n, b.n, k=k)
        else:
            from .ops.knn import knn

            idx_k, d_k = knn(a.points, b.points, k=k)
        idx, d = idx_k[: a.n, n], d_k[: a.n, n]
    rows = idx.long()
    pts = b.points[rows].double().cpu().numpy()
    colors = None
    if b.colors is not None:
        colors = b.colors[rows].double().cpu().numpy()
    neigh = Cloud.from_numpy(pts, colors=colors, dtype=a.points.dtype,
                             device=a.device)
    return neigh, d.double().cpu().numpy()
