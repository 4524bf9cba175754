"""Morton-ordered chunk grid: the spatial acceleration structure for pruned NN.

Port of ``open_pcc_metric_tpu/ops/grid.py``:

  1. quantise valid points to a 1024^3 lattice over their bounding box and
     interleave bits into 30-bit Morton codes (locality-preserving),
  2. sort by code (stable, so equal codes keep row order),
  3. cut the sorted order into fixed 256-point chunks and record each chunk's
     axis-aligned bounding box.

Padded sentinel rows carry the lattice-corner code and sort to the tail, so
sorted row s is valid iff s < n everywhere downstream.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from ..utils.profiling import spanned

CHUNK = 256  # points per chunk; cloud.pad_bucket guarantees divisibility

# Sentinel rows carry the lattice-corner code (all three 10-bit axes maxed).
_SENTINEL_CODE = 0x3FFFFFFF


class ChunkGrid(typing.NamedTuple):
    points: torch.Tensor  # (P, 3) Morton-sorted
    perm: torch.Tensor  # (P,) int32: sorted row s holds original row perm[s]
    codes: torch.Tensor  # (P,) int32 sorted Morton codes
    bbox_lo: torch.Tensor  # (P/CHUNK, 3)
    bbox_hi: torch.Tensor  # (P/CHUNK, 3)
    chunk_codes: torch.Tensor  # (P/CHUNK,) code of each chunk's first point

    @property
    def n_chunks(self) -> int:
        return self.bbox_lo.shape[0]


def _part1by2(x):
    """Spread the low 10 bits of x so there are 2 zero bits between each.

    Works on int32 torch tensors and on uint32 numpy arrays alike."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor, n_valid: int) -> torch.Tensor:
    """30-bit int32 Morton codes on a 1024^3 lattice fitted to the VALID points.

    The float arithmetic is the JAX package's op for op, in the points'
    dtype. The lattice index is clamped to [0, 1023] in float BEFORE the
    integer cast: sentinel rows quantise to ~3.9e9, which a float->int32
    cast handles differently on every backend (XLA saturates, torch on the
    CPU wraps to INT32_MIN). Clamping first gives every sentinel row the
    lattice corner on every device, so sentinels sort last.
    """
    p = points.shape[0]
    mask = (torch.arange(p, device=points.device) < n_valid)[:, None]
    big = torch.finfo(points.dtype).max
    lo = torch.where(mask, points, big).amin(dim=0)
    hi = torch.where(mask, points, -big).amax(dim=0)
    extent = torch.clamp(hi - lo, min=1e-9)
    # A true division: torch evaluates ``1023.0 / extent`` as
    # reciprocal(extent) * 1023, which rounds differently.
    scale = torch.full_like(extent, 1023.0) / extent
    scaled = (points - lo) * scale
    q = torch.clamp(scaled, 0.0, 1023.0).to(torch.int32)
    return (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << 1)
        | (_part1by2(q[:, 2]) << 2)
    )


def _chunk_grid(sorted_pts, perm, sorted_codes) -> ChunkGrid:
    tiles = sorted_pts.reshape(-1, CHUNK, 3)
    return ChunkGrid(
        points=sorted_pts,
        perm=perm,
        codes=sorted_codes,
        bbox_lo=tiles.amin(dim=1),
        bbox_hi=tiles.amax(dim=1),
        chunk_codes=sorted_codes[::CHUNK].contiguous(),
    )


@spanned("pcc.grid")
def build_grid(points: torch.Tensor, n_valid: int) -> ChunkGrid:
    """Grid built on the points' device.

    A stable sort on the int32 codes gives the permutation of JAX's 2-key
    (code, row) sort bit for bit.
    """
    codes = morton_codes(points, n_valid)
    sorted_codes, perm = torch.sort(codes, stable=True)
    perm = perm.to(torch.int32)
    return _chunk_grid(points[perm], perm, sorted_codes)


def bbox_lower_bounds(
    a_lo: torch.Tensor, a_hi: torch.Tensor, b_lo: torch.Tensor, b_hi: torch.Tensor
) -> torch.Tensor:
    """Squared distance lower bound between every (a-tile, b-chunk) bbox pair.

    lb[i, c] <= ||x - y||^2 for any x in a-box i, y in b-box c. Accumulated
    per coordinate (x, then y, then z) so only (na, nb) temporaries exist.
    """
    out = None
    for k in range(3):
        gap = torch.clamp(
            torch.maximum(
                a_lo[:, None, k] - b_hi[None, :, k],
                b_lo[None, :, k] - a_hi[:, None, k],
            ),
            min=0.0,
        )
        sq = gap * gap
        out = sq if out is None else out + sq
    return out


@spanned("pcc.grid")
def build_grid_host(
    points_np,
    pad_to: int,
    dtype: torch.dtype = torch.float32,
    *,
    device: typing.Union[str, torch.device, None] = None,
) -> ChunkGrid:
    """Host-side grid build from the original float64 points.

    Quantises in float64, so cells can differ from ``build_grid``'s at cell
    boundaries; pruned-NN exactness never depends on the Morton assignment,
    only pruning efficiency does.
    """
    from .. import native
    from ..cloud import PAD_SENTINEL, numpy_dtype

    pts = np.asarray(points_np, dtype=np.float64).reshape(-1, 3)
    n = pts.shape[0]
    if pad_to % CHUNK or pad_to < n:
        raise ValueError(f"pad_to={pad_to} invalid for n={n}")
    lo = pts.min(axis=0)
    extent = np.maximum(pts.max(axis=0) - lo, 1e-9)
    q = np.clip(((pts - lo) * (1023.0 / extent)).astype(np.int64), 0, 1023)
    q = q.astype(np.uint32)
    codes = (
        _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    ).astype(np.int64)

    perm = native.radix_argsort_u32(codes.astype(np.uint32))
    if perm is None:
        perm = np.argsort(codes, kind="stable")

    buf = np.full((pad_to, 3), PAD_SENTINEL, dtype=np.float64)
    gathered = native.gather_rows(pts, perm)
    buf[:n] = gathered if gathered is not None else pts[perm]
    # Round to the target dtype BEFORE taking bboxes: bounds must enclose the
    # exact on-device point values or the lower bounds stop being sound.
    buf = buf.astype(numpy_dtype(dtype))
    perm_full = np.concatenate([perm, np.arange(n, pad_to)]).astype(np.int32)
    codes_full = np.concatenate(
        [codes[perm], np.full(pad_to - n, _SENTINEL_CODE, dtype=np.int64)]
    ).astype(np.int32)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return _chunk_grid(dev(buf), dev(perm_full), dev(codes_full))
