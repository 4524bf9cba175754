"""Point-cloud containers with padded, fixed-bucket storage (PyTorch).

Port of ``open_pcc_metric_tpu/cloud.py``. A cloud is a set of padded torch
tensors on one device plus a valid-point count, so downstream kernels see a
small number of bucketed shapes.

Padding convention (unchanged from the JAX package):
  * ``points`` rows >= n are set to ``PAD_SENTINEL`` (a huge coordinate) so a
    padded row can never be the nearest neighbour of a valid query point.
  * ``colors`` / ``normals`` rows >= n are zero.
  * All reductions downstream mask by row index < n.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

# Large-but-finite sentinel: squared distances to it stay finite in float32
# (~3e18 << 3.4e38), so min/argmin logic never sees NaN/inf.
PAD_SENTINEL = 1.0e9

# The refine kernel tiles queries by 256 rows; keep every padded size a multiple.
_MIN_ALIGN = 256

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_bucket(n: int, policy: str = "bucket") -> int:
    """Round ``n`` up to a bucketed padded size.

    policy="bucket": multiples of ``max(_MIN_ALIGN, 2^(floor(log2 n) - 3))``
    — at most ~12.5% padding waste with a logarithmic number of shapes.
    policy="pow2": next power of two — up to 2x waste, but heterogeneous
    sweeps collapse onto very few shapes.
    """
    if policy not in ("bucket", "pow2"):
        raise ValueError(f"unknown pad policy {policy!r}")
    if n <= _MIN_ALIGN:
        return _MIN_ALIGN
    if policy == "pow2":
        return 1 << int(n - 1).bit_length()
    step = max(_MIN_ALIGN, 1 << (int(n - 1).bit_length() - 4))
    return round_up(n, step)


def numpy_dtype(dtype: torch.dtype):
    if dtype not in _NP_DTYPES:
        raise ValueError(f"unsupported cloud dtype {dtype}")
    return _NP_DTYPES[dtype]


@dataclasses.dataclass
class Cloud:
    """A padded point cloud on one torch device.

    Attributes:
      points:  (P, 3) float tensor; rows >= n are PAD_SENTINEL.
      n:       number of valid points.
      colors:  optional (P, 3) float tensor in [0, 1] (Open3D convention).
      normals: optional (P, 3) float tensor, unit length for valid rows.
      host_points: the original float64 valid points (kept by from_numpy)
               for host-side work: grid builds, minimal-OBB hulls.

    The remaining fields cache per-cloud state that depends only on the
    cloud (grid, OBB extent, sorted colours, boundary stats, estimated
    normals); a Cloud is immutable after construction, so the caches never
    go stale.
    """

    points: torch.Tensor
    n: int
    colors: typing.Optional[torch.Tensor] = None
    normals: typing.Optional[torch.Tensor] = None
    host_points: typing.Optional[np.ndarray] = None
    _grid: typing.Any = dataclasses.field(default=None, init=False, repr=False)
    _obb_extent: typing.Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False)
    _sorted_colors: typing.Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False)
    _boundary_stats: typing.Any = dataclasses.field(
        default=None, init=False, repr=False)
    _est_normals: typing.Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False)

    @property
    def padded_size(self) -> int:
        return int(self.points.shape[0])

    @property
    def device(self) -> torch.device:
        return self.points.device

    @staticmethod
    def from_numpy(
        points: np.ndarray,
        colors: typing.Optional[np.ndarray] = None,
        normals: typing.Optional[np.ndarray] = None,
        device: typing.Union[str, torch.device, None] = None,
        dtype: torch.dtype = torch.float32,
        pad_to: typing.Optional[int] = None,
        pad_policy: str = "bucket",
    ) -> "Cloud":
        """Build a padded Cloud on ``device`` (torch's default when None).

        Padding and the float64 -> ``dtype`` cast happen on the host, so the
        device receives exactly the bits the JAX package uploads.
        """
        np_dtype = numpy_dtype(dtype)
        points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        n = points.shape[0]
        if n == 0:
            raise ValueError("empty point cloud")
        p = pad_to if pad_to is not None else pad_bucket(n, pad_policy)
        if p < n:
            raise ValueError(f"pad_to={p} < n={n}")

        def upload(values, fill, name):
            if values is None:
                return None
            values = np.asarray(values, dtype=np.float64).reshape(-1, 3)
            if values.shape[0] != n:
                raise ValueError(f"{name}/points length mismatch")
            buf = np.full((p, 3), fill, dtype=np.float64)
            buf[:n] = values
            return torch.from_numpy(buf.astype(np_dtype)).to(device)

        return Cloud(
            points=upload(points, PAD_SENTINEL, "points"),
            n=n,
            colors=upload(colors, 0.0, "colors"),
            normals=upload(normals, 0.0, "normals"),
            host_points=points,
        )

    def valid_points(self) -> np.ndarray:
        """Valid points as a host numpy array (for host-side algorithms)."""
        if self.host_points is not None:
            return self.host_points
        return self.points[: self.n].cpu().numpy().astype(np.float64)

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.padded_size, device=self.device) < self.n

    def get_obb_extent(self) -> np.ndarray:
        """Cached minimal-OBB extent of this cloud (projection sweep on its
        device, hull and refinement on the host)."""
        if self._obb_extent is None:
            from .ops.obb import minimal_obb_extent

            self._obb_extent = minimal_obb_extent(
                self.valid_points(), device=self.device)
        return self._obb_extent

    def get_grid(self, build: str = "auto"):
        """Lazily built, cached Morton chunk grid of this cloud.

        ``build``: "device" sorts on the cloud's device (``build_grid``),
        "host" sorts the float64 host points (``build_grid_host``), "auto"
        picks host for CPU clouds and device otherwise — the JAX package's
        default. Either grid gives the same exact NN results.
        """
        if self._grid is None:
            from .ops.grid import build_grid, build_grid_host

            if build == "auto":
                build = "host" if self.device.type == "cpu" else "device"
            if build not in ("host", "device"):
                raise ValueError(f"unknown grid build {build!r}")
            if build == "host" and self.host_points is not None:
                self._grid = build_grid_host(
                    self.host_points, self.padded_size,
                    dtype=self.points.dtype, device=self.device)
            else:
                self._grid = build_grid(self.points, self.n)
        return self._grid

    def get_normals(self) -> torch.Tensor:
        """Padded normals: from the file, else estimated and cached.

        The reference estimates normals when the file has none (reference
        cloud_pair.py:61-64, Open3D's default 30-NN PCA); the estimate
        depends only on this cloud's points, so it is cached like the grid
        and shared by every pair the cloud joins.
        """
        if self.normals is not None:
            return self.normals
        if self._est_normals is None:
            from .ops.normals import estimate_normals_cloud

            self._est_normals = estimate_normals_cloud(self)
        return self._est_normals


def synthetic_sphere_pair(
    n: int = 10_000,
    noise: float = 0.01,
    seed: int = 0,
    with_colors: bool = True,
    device: typing.Union[str, torch.device, None] = None,
    dtype: torch.dtype = torch.float32,
) -> typing.Tuple[Cloud, Cloud]:
    """Clean-vs-perturbed sphere pair (same numpy draws as the JAX package)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * 100.0
    colors = (pts - pts.min(0)) / (pts.max(0) - pts.min(0)) if with_colors else None
    noisy = pts + rng.normal(scale=noise * 100.0, size=pts.shape)
    a = Cloud.from_numpy(pts, colors=colors, device=device, dtype=dtype)
    b = Cloud.from_numpy(noisy, colors=colors, device=device, dtype=dtype)
    return a, b


def synthetic_voxel_pair(
    n: int = 10_000,
    grid: int = 512,
    seed: int = 0,
    with_colors: bool = True,
    device: typing.Union[str, torch.device, None] = None,
    dtype: torch.dtype = torch.float32,
) -> typing.Tuple[Cloud, Cloud]:
    """Integer-grid (voxelised) pair: original vs re-quantised-with-loss.

    Integer coordinates < 2^10 make all float32 distance math exact.
    """
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, grid, size=(n, 3)), axis=0).astype(np.float64)
    rec = np.unique((pts // 4) * 4 + 2, axis=0)
    colors = None
    rcolors = None
    if with_colors:
        colors = (rng.integers(0, 256, size=pts.shape) / 255.0)
        rcolors = (rng.integers(0, 256, size=rec.shape) / 255.0)
    a = Cloud.from_numpy(pts, colors=colors, device=device, dtype=dtype)
    b = Cloud.from_numpy(rec, colors=rcolors, device=device, dtype=dtype)
    return a, b
