"""Exact nearest-neighbour search between padded point sets.

Port of ``open_pcc_metric_tpu/ops/nn.py`` and ``ops/nn_pallas.py``:

  * ``nn_chunked``: brute-force 1-NN in plain PyTorch, on any device and
    float dtype (the plain version of K5, and the CPU path).
  * ``nn_argmin``: K5, the brute-force 1-NN kernel ``csrc/nn_brute.cu`` on
    CUDA tensors, ``nn_chunked`` on CPU tensors.
  * ``nearest_neighbors``: the dispatcher. Below ``PRUNE_THRESHOLD`` padded
    rows the brute force (K5); at or above it the bound-pruned search
    (``nn_pruned``, K1).

Semantics (the JAX package's, which match FLANN as the reference uses it):
SQUARED distances and int32 indices into b's padded rows, ties to the
lowest index, ``exclude_self`` masks the pair i == i. Every distance is
((dx^2 + dy^2) + dz^2), each step rounded on its own: the rounding of the
refine kernels (``refine._offsets``, ``csrc/pcc_common.cuh``), so K5 returns
its distances directly and they equal K1's bit for bit. Padded rows carry
``PAD_SENTINEL`` coordinates and never win for a valid query; callers mask
query rows >= n.
"""
from __future__ import annotations

import functools
import typing

import torch

from . import nn_pruned, refine
from .refine import INT_MAX, MAX_SPLITS, _launch, _offsets, sm_count
from .._layout_args import check_chunk
from ..utils.profiling import spanned

# At or above this many padded rows the bound-pruned search takes over from
# the brute force (the JAX package's value).
PRUNE_THRESHOLD = 65536

# "pallas" and "jnp" are the JAX package's names of its brute-force
# backends; they select the brute force here, so its CLI lines work as they
# are.
BACKENDS = ("auto", "pruned", "brute", "pallas", "jnp")

# Bounds one (query rows x search rows) distance block's element count.
_BLOCK_ELEMS = 1 << 24

# K5's launch shape (csrc/nn_brute.cu kThreads, kRows): threads a block,
# and the query rows a thread holds.
_THREADS = 128
ROWS = 4


def resolve_backend(backend: str, padded_rows: int) -> str:
    """"pruned" or "brute" for a backend name and the larger cloud's
    padded row count ("auto": pruned at or above PRUNE_THRESHOLD)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown NN backend {backend!r}; one of {BACKENDS}")
    if backend == "auto":
        return "pruned" if padded_rows >= PRUNE_THRESHOLD else "brute"
    return "pruned" if backend == "pruned" else "brute"


def _check_points(a_points: torch.Tensor, b_points: torch.Tensor) -> None:
    for name, x in (("a_points", a_points), ("b_points", b_points)):
        if x.ndim != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3), got {tuple(x.shape)}")
    if a_points.dtype != b_points.dtype or a_points.device != b_points.device:
        raise ValueError("a_points and b_points must share one dtype and device")
    if b_points.shape[0] == 0:
        raise ValueError("b_points has no rows to search")


def nn_chunked(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    exclude_self: bool = False,
    chunk_a: int = 256,
    chunk_b: int = 1024,
    a_offset: int = 0,
    b_offset: int = 0,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force 1-NN: for each row of ``a`` the nearest row of ``b``.

    Returns ``(idx int32 (Na,), dist_sq (Na,) in a's dtype)``; ``idx`` is
    local to ``b`` and the lexicographic (d, index) minimum, so ties go to
    the lowest index. ``a_offset``/``b_offset`` are the global row offsets
    of the two blocks: with ``exclude_self`` the masked pair is
    ``a_offset + i == b_offset + j`` (d = inf), which lets a ring-sharded
    self search exclude the true global diagonal. ``chunk_a``/``chunk_b``
    are the JAX package's tile sizes, checked and unused: the distances go
    in blocks of ``_BLOCK_ELEMS`` elements here.
    """
    check_chunk("chunk_a", chunk_a)
    check_chunk("chunk_b", chunk_b)
    _check_points(a_points, b_points)
    na, nb = a_points.shape[0], b_points.shape[0]
    dev = a_points.device
    idx = torch.empty(na, dtype=torch.int32, device=dev)
    dist = torch.empty(na, dtype=a_points.dtype, device=dev)
    cols = torch.arange(nb, dtype=torch.int32, device=dev)
    rows = max(1, _BLOCK_ELEMS // nb)
    for s in range(0, na, rows):
        e = min(na, s + rows)
        d = _offsets(a_points[None, s:e], b_points[None, None])[3][0]
        if exclude_self:
            own = torch.arange(s + a_offset, e + a_offset, device=dev)[:, None] \
                == (cols[None, :] + b_offset)
            d = d.masked_fill(own, torch.inf)
        dmin = d.amin(dim=1)
        idx[s:e] = torch.where(d == dmin[:, None], cols, INT_MAX).amin(dim=1)
        dist[s:e] = dmin
    return idx, dist


def recompute_dist_sq(
    a_points: torch.Tensor, b_points: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Squared distance from each row of ``a`` to row ``idx`` of ``b``, in
    the kernels' rounding: nn_argmin's distances equal it bit for bit."""
    nb = b_points[idx.long()]
    return _offsets(a_points[:, None], nb[:, None, None])[3][:, 0, 0]


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def split_count(na: int, nb: int, sms: int, blocks_per_sm: int) -> int:
    """K5's ranges of b's rows a query block: as many as one wave of the
    card holds (``sms`` x ``blocks_per_sm`` resident blocks over the
    cdiv(na, 128 * ROWS) query blocks), at most MAX_SPLITS (the portable
    cluster size) and nb. On an H100 at 61440 query rows: 8."""
    query_blocks = _cdiv(na, _THREADS * ROWS)
    return max(1, min(MAX_SPLITS, sms * blocks_per_sm // query_blocks, nb))


@functools.lru_cache(maxsize=None)
def occupancy() -> typing.Tuple[int, int]:
    """(registers a thread, resident blocks an SM) of K5 on the current CUDA
    device (``refine.occupancy``), kept once read: every launch sizes its
    split from it."""
    return refine.occupancy("nn_brute")


@spanned("pcc.sweep")
def nn_argmin(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    exclude_self: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(idx int32 (Na,), dist_sq (Na,))``, the contract of
    ``nn_chunked`` with zero offsets.

    CPU tensors run ``nn_chunked``. CUDA tensors launch the kernel on the
    current stream, or raise: the kernel takes float32 only, both tensors
    contiguous and on one device. Each launch adds one to
    ``nn_argmin.launches``.
    """
    _check_points(a_points, b_points)
    if a_points.device.type == "cpu":
        return nn_chunked(a_points, b_points, exclude_self)
    if a_points.device.type != "cuda":
        raise ValueError(f"nn_argmin runs on cpu or cuda, not {a_points.device}")
    if a_points.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, not {a_points.dtype}")
    if not (a_points.is_contiguous() and b_points.is_contiguous()):
        raise ValueError("nn_argmin: tensors must be contiguous")
    na, nb = a_points.shape[0], b_points.shape[0]
    dev = a_points.device
    out_d = torch.empty(na, dtype=torch.float32, device=dev)
    out_i = torch.empty(na, dtype=torch.int32, device=dev)
    if na == 0:
        return out_i, out_d
    splits = split_count(na, nb, sm_count(dev), occupancy()[1])
    _launch("nn_brute", dev, [a_points, b_points, out_d, out_i],
            [na, nb, splits, int(bool(exclude_self))])
    nn_argmin.launches += 1
    return out_i, out_d


nn_argmin.launches = 0


def nearest_neighbors(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    exclude_self: bool = False,
    backend: str = "auto",
    n_a: typing.Optional[int] = None,
    n_b: typing.Optional[int] = None,
    grids: typing.Optional[tuple] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching 1-NN. Returns ``(idx int32 (Na,), dist_sq (Na,))``.

    Backends: "pruned" (Morton-grid bound pruning, exact), "brute" (K5;
    "pallas" and "jnp" are its aliases), "auto" (pruned at or above
    PRUNE_THRESHOLD padded rows, else brute). ``grids`` optionally carries
    prebuilt ``(ga, gb)`` ChunkGrids for the pruned search.
    """
    rows = max(a_points.shape[0], b_points.shape[0])
    if resolve_backend(backend, rows) == "brute":
        return nn_argmin(a_points, b_points, exclude_self)
    n_a = int(n_a) if n_a is not None else a_points.shape[0]
    if grids is not None:
        ga, gb = grids
        return nn_pruned.nn_pruned_with_grids(ga, gb, n_a,
                                              exclude_self=exclude_self)
    n_b = int(n_b) if n_b is not None else b_points.shape[0]
    return nn_pruned.nn_pruned(a_points, b_points, n_a, n_b,
                               exclude_self=exclude_self)
