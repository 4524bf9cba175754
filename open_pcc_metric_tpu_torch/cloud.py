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

import concurrent.futures
import dataclasses
import os
import typing

import numpy as np
import torch

from .utils.profiling import span

# Large-but-finite sentinel: squared distances to it stay finite in float32
# (~3e18 << 3.4e38), so min/argmin logic never sees NaN/inf.
PAD_SENTINEL = 1.0e9

# The refine kernel tiles queries by 256 rows; keep every padded size a multiple.
_MIN_ALIGN = 256

# Largest |coordinate| at which the expanded-norm distance |q|^2 + |b|^2 -
# 2<q, b> of an integer cloud is exact in float32: every term an integer,
# |q|^2 + |b|^2 <= 6 C^2 < 2^24 (C = 1672 is the boundary; 1600 leaves
# margin). The JAX package's refine_adaptive.MXU_EXACT_MAX_COORD.
MXU_EXACT_MAX_COORD = 1600.0

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

# --- thin host->device transfers -------------------------------------------
# When a cloud's payload is exactly representable in a narrower dtype —
# integer voxel coordinates in int16, 8-bit colours in uint8 — uploading the
# narrow array and widening it on the device is bit-identical and moves 21
# bytes a point instead of 36 (normals stay float32). The widen steps are
# plain torch ops on the cloud's device, queued on the current stream.


def _hydrate_points_i16(pts_i16: torch.Tensor, n: int) -> torch.Tensor:
    """(P, 3) int16 + valid count -> (P, 3) float32 with a PAD_SENTINEL tail.

    Exact: |coord| <= 32766 int16 -> float32 is lossless (24-bit mantissa).
    """
    f = pts_i16.to(torch.float32)
    rows = torch.arange(f.shape[0], device=f.device)[:, None] < n
    return torch.where(rows, f, torch.full_like(f, PAD_SENTINEL))


# Canonical u8 -> float32 colour values, computed on the host in float64
# (the loaders' conversion). A 256-entry table gather is bit-exact; an
# arithmetic form is not: torch rewrites c / 255 as c * (1 / 255), which
# differs by 1 ulp for 46 of the 256 values.
_U8_COLOR_TABLE = np.asarray(
    np.arange(256, dtype=np.float64) / 255.0, dtype=np.float32)


def _hydrate_colors_u8(col_u8: torch.Tensor) -> torch.Tensor:
    """(P, 3) uint8 -> float32 in [0, 1], via the canonical table."""
    table = torch.from_numpy(_U8_COLOR_TABLE).to(col_u8.device)
    return table[col_u8.long()]


# The largest |coordinate| the thin upload sends as int16.
THIN_I16_MAX = 32766.0


def _as_int16_points(points: np.ndarray) -> typing.Optional[np.ndarray]:
    """points (n, 3) float64 -> int16 when exactly representable."""
    r = np.rint(points)
    if (np.abs(r).max(initial=0.0) <= THIN_I16_MAX
            and np.array_equal(r, points)):
        return r.astype(np.int16)
    return None


def _as_uint8_colors(colors: np.ndarray) -> typing.Optional[np.ndarray]:
    """colors (n, 3) float64 in [0, 1] -> uint8 when exactly c = u/255."""
    scaled = colors * 255.0
    r = np.rint(scaled)
    if r.min(initial=0.0) < 0.0 or r.max(initial=0.0) > 255.0:
        return None
    if np.array_equal(r / 255.0, colors):
        return r.astype(np.uint8)
    return None


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_bucket(n: int, policy: str = "bucket") -> int:
    """Round ``n`` up to a bucketed padded size.

    policy="bucket": multiples of ``max(_MIN_ALIGN, 2^(floor(log2 n) - 3))``
    — at most ~12.5% padding waste with a logarithmic number of shapes.
    policy="pow2": next power of two — up to 2x waste, but heterogeneous
    sweeps collapse onto very few shapes. policy="auto": ``PCC_PAD_POLICY``
    read at this call, "pow2" or else "bucket", as in the JAX package.
    """
    if policy == "auto":
        policy = "pow2" if os.environ.get("PCC_PAD_POLICY") == "pow2" \
            else "bucket"
    if policy not in ("bucket", "pow2"):
        raise ValueError(f"unknown pad policy {policy!r}")
    if n <= _MIN_ALIGN:
        return _MIN_ALIGN
    if policy == "pow2":
        return 1 << int(n - 1).bit_length()
    step = max(_MIN_ALIGN, 1 << (int(n - 1).bit_length() - 4))
    return round_up(n, step)


def resolve_device(
        device: typing.Union[str, torch.device, None]) -> torch.device:
    """The device a library entry point runs on: ``device`` when given,
    else the CUDA device. Without one, a call that names no device raises
    instead of running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available, and the port runs on the card "
            "unless asked otherwise; pass device='cpu' to evaluate on the CPU")
    return torch.device("cuda")


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
      host_points: the original float64 valid points (kept by from_numpy;
               a PLY decoded on the card, ``io/ply_decode.py``, keeps them
               where its loader asked for them early or float32 cannot hold
               them) for host-side work: grid builds, minimal-OBB hulls.

    The remaining fields cache per-cloud state that depends only on the
    cloud (grid, OBB extent, sorted colours and normals, boundary stats,
    estimated normals, the ``mxu_exact`` gate); a Cloud is immutable after
    construction, so the caches never go stale.
    """

    points: torch.Tensor
    n: int
    colors: typing.Optional[torch.Tensor] = None
    normals: typing.Optional[torch.Tensor] = None
    host_points: typing.Optional[np.ndarray] = None
    _grid: typing.Any = dataclasses.field(default=None, init=False, repr=False)
    _obb_extent: typing.Union[np.ndarray, concurrent.futures.Future,
                              None] = dataclasses.field(
        default=None, init=False, repr=False)
    _sorted_colors: typing.Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False)
    _boundary_stats: typing.Any = dataclasses.field(
        default=None, init=False, repr=False)
    _est_normals: typing.Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False)
    _sorted_normals: typing.Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False)
    _mxu_exact: typing.Optional[bool] = dataclasses.field(
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
        dtype: torch.dtype = torch.float32,
        pad_to: typing.Optional[int] = None,
        thin: typing.Union[bool, str] = "auto",
        *,
        device: typing.Union[str, torch.device, None] = None,
        pad_policy: str = "auto",
    ) -> "Cloud":
        """Build a padded Cloud on ``device`` (the CUDA device when None;
        ``resolve_device`` raises when there is none), padded to ``pad_to``
        or else to ``pad_bucket(n, pad_policy)`` (by default the
        ``PCC_PAD_POLICY`` policy, read at this call).

        The positional arguments are the JAX package's (points, colors,
        normals, dtype, pad_to, thin); ``device`` and ``pad_policy`` are
        keyword-only.

        ``thin`` ("auto", True or False) selects the narrow upload of a
        float32 cloud: int16 points and uint8 colours, widened on the device
        (``_hydrate_points_i16``, ``_hydrate_colors_u8``), each array only
        when its values are exactly representable. "auto" means thin on a
        CUDA device. Either way the device holds the same bits: padding and
        the float64 -> ``dtype`` cast of a wide array happen on the host, so
        the device receives exactly the bits the JAX package uploads.
        """
        if not isinstance(dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, not {dtype!r} "
                            "(device is keyword-only)")
        if not (isinstance(thin, bool) or (isinstance(thin, str)
                                           and thin == "auto")):
            raise TypeError(f"thin must be 'auto' or a bool, not {thin!r} "
                            "(device is keyword-only)")
        device = resolve_device(device)
        np_dtype = numpy_dtype(dtype)
        points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        n = points.shape[0]
        if n == 0:
            raise ValueError("empty point cloud")
        p = pad_to if pad_to is not None else pad_bucket(n, pad_policy)
        if p < n:
            raise ValueError(f"pad_to={p} < n={n}")
        if thin == "auto":
            thin = device.type == "cuda"
        thin = thin and dtype == torch.float32

        def rows(values, name):
            if values is None:
                return None
            values = np.asarray(values, dtype=np.float64).reshape(-1, 3)
            if values.shape[0] != n:
                raise ValueError(f"{name}/points length mismatch")
            return values

        def padded(values, fill, np_type):
            """Rows >= n filled on the host, then one upload; a float64
            -> float32 cast rounds on the host."""
            buf = np.full((p, 3), fill, dtype=np_type)
            buf[:n] = values
            return torch.from_numpy(buf).to(device)

        colors, normals = rows(colors, "colors"), rows(normals, "normals")
        tpoints = tcolors = None
        if thin:
            pts16 = _as_int16_points(points)
            if pts16 is not None:
                tpoints = _hydrate_points_i16(padded(pts16, 0, np.int16), n)
            col8 = None if colors is None else _as_uint8_colors(colors)
            if col8 is not None:
                tcolors = _hydrate_colors_u8(padded(col8, 0, np.uint8))
        if tpoints is None:
            tpoints = padded(points, PAD_SENTINEL, np_dtype)
        if tcolors is None and colors is not None:
            tcolors = padded(colors, 0.0, np_dtype)
        return Cloud(
            points=tpoints,
            n=n,
            colors=tcolors,
            normals=None if normals is None else padded(normals, 0.0,
                                                         np_dtype),
            host_points=points,
        )

    @staticmethod
    def _decoded(points: torch.Tensor, n: int,
                 colors: typing.Optional[torch.Tensor],
                 normals: typing.Optional[torch.Tensor],
                 host_points: typing.Optional[np.ndarray], *,
                 mxu_exact: bool) -> "Cloud":
        """A Cloud from tensors already padded on its device, with its
        ``mxu_exact`` answer known at load (``io/ply_decode.py``)."""
        cloud = Cloud(points=points, n=n, colors=colors, normals=normals,
                      host_points=host_points)
        cloud._mxu_exact = mxu_exact
        return cloud

    def valid_points(self) -> np.ndarray:
        """Valid points as a host numpy array (for host-side algorithms)."""
        if self.host_points is not None:
            return self.host_points
        with span("pcc.readback"):
            host = self.points[: self.n].cpu()
        return host.numpy().astype(np.float64)

    def has_colors(self) -> bool:
        """Whether the cloud carries colours."""
        return self.colors is not None

    def has_normals(self) -> bool:
        """Whether the file gave normals (estimated ones do not count)."""
        return self.normals is not None

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.padded_size, device=self.device) < self.n

    def mxu_exact(self) -> bool:
        """Whether expanded-norm distances are exact for this cloud: every
        valid coordinate an integer with |coord| <= MXU_EXACT_MAX_COORD.
        Voxelised clouds (the pc_error workload) qualify; the adaptive and
        expanded schedules run only on pairs that do. Cached."""
        if self._mxu_exact is None:
            pts = self.valid_points()
            self._mxu_exact = bool(
                np.abs(pts).max(initial=0.0) <= MXU_EXACT_MAX_COORD
                and np.array_equal(pts, np.round(pts)))
        return self._mxu_exact

    def get_obb_extent(self) -> np.ndarray:
        """Cached minimal-OBB extent of this cloud (projection sweep on its
        device, hull and refinement on the host). A pending extent (a
        future: a hull ``evaluate`` or ``fused_evaluate`` started) is waited
        for here; one whose hull raised raises here at every call."""
        if isinstance(self._obb_extent, concurrent.futures.Future):
            self._obb_extent = self._obb_extent.result()
        if self._obb_extent is None:
            from .ops.obb import minimal_obb_extent

            self._obb_extent = minimal_obb_extent(
                self.valid_points(), device=self.device)
        return self._obb_extent

    def get_grid(self, *, build: str = "auto"):
        """Lazily built, cached Morton chunk grid of this cloud.

        ``build``: "device" sorts on the cloud's device (``build_grid``),
        "host" sorts the float64 host points (``build_grid_host``), "auto"
        reads ``PCC_GRID_BUILD`` at this call as the JAX package does
        ("host", "auto" or anything else for "device"), and "auto" picks
        host for CPU clouds and device otherwise. Either grid is the same.
        """
        if self._grid is None:
            from .ops.grid import build_grid, build_grid_host

            if build == "auto":
                env = os.environ.get("PCC_GRID_BUILD", "auto")
                build = env if env in ("host", "auto") else "device"
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
    dtype: torch.dtype = torch.float32,
    *,
    device: typing.Union[str, torch.device, None] = None,
) -> typing.Tuple[Cloud, Cloud]:
    """Clean-vs-perturbed sphere pair (same numpy draws as the JAX package),
    on ``device`` (keyword-only, as in ``Cloud.from_numpy``)."""
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
    dtype: torch.dtype = torch.float32,
    *,
    device: typing.Union[str, torch.device, None] = None,
) -> typing.Tuple[Cloud, Cloud]:
    """Integer-grid (voxelised) pair: original vs re-quantised-with-loss
    (same numpy draws as the JAX package), on ``device`` (keyword-only).

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
