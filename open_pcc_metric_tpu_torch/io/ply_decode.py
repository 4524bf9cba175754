"""Binary PLY records decoded on the card (K9, ``csrc/ply_decode.cu``).

The host path (``loaders._read_ply`` and ``Cloud.from_numpy``) splits a
binary PLY's vertex records into float64 columns, scales the colours, runs
the thin upload's checks, pads every array and uploads each from pageable
memory. For a float32 cloud bound for a CUDA device whose file is a binary
little-endian PLY with the vertex element first and scalar properties only
(the layout of ``_read_ply``'s bounded fast path), ``stage`` instead reads
the vertex block into page-locked memory (torch's caching pinned
allocator, so the buffer is reused once its copy is done), and
``Staged.upload`` copies it to the card as it is and splits it there with
one kernel into the bits the host path uploads. ``stage`` returns None for
every other file, device and dtype, which keep the host path.

  * ``decode_records``: K9 on CUDA tensors, ``decode_reference`` (its
    plain PyTorch version, the kernel's reference in the tests) on any
    other device.
  * The kernel's flags say whether the cloud passes ``Cloud.mxu_exact``
    and whether float32 holds every coordinate; only where it does not are
    the float64 points decoded on the host, from the staging buffer.
"""
from __future__ import annotations

import contextlib
import os
import typing

import numpy as np
import torch

from . import loaders
from ..cloud import (MXU_EXACT_MAX_COORD, PAD_SENTINEL, THIN_I16_MAX, Cloud,
                     pad_bucket, resolve_device)
from ..utils.profiling import span

# Field types as the kernel codes them: (byte offset << 3) | type.
_TYPES = {"i1": 0, "u1": 1, "i2": 2, "u2": 3, "i4": 4, "u4": 5, "f4": 6,
          "f8": 7}
# Colour scales: the first channel's type picks it (_assemble_ply_cloud).
_SCALES = {"uchar": 1, "uint8": 1, "ushort": 2, "uint16": 2}
_DIVISORS = {1: 255.0, 2: 65535.0}

# Flag bits (ply_decode.cu's Flag).
NOT_MXU, NOT_F32, NOT_I16, NOT_U8 = 1, 2, 4, 8
POINT_NEG_ZERO, COLOR_NEG_ZERO = 16, 32


def records_a_block(stride: int) -> int:
    """K9's records a block at ``stride``-byte records (0: too wide): the
    one Python copy of ply_decode.cu's ``records_a_block``, with its
    ``kThreads`` (256) and ``kSharedBytes`` (47 KB). ``layout`` needs it
    before any card is asked, so that a record too wide keeps the host
    path; the kernel's entry refuses such a stride itself."""
    return min(256, 47 * 1024 // stride // 16 * 16)


class Layout(typing.NamedTuple):
    """Where each field of a PLY's vertex records lies."""

    path: str
    n: int
    offset: int  # the vertex block's byte offset in the file
    dtype: np.dtype  # the record, as the host path reads it
    fields: typing.Tuple[int, ...]  # x, y, z, colours, normals: codes, -1
    scale: int  # 0, or 1 (/255) or 2 (/65535)
    colors: bool
    normals: bool

    @property
    def stride(self) -> int:
        return self.dtype.itemsize

    @property
    def buffer_bytes(self) -> int:
        """The vertex block's bytes rounded up to 16 (K9 reads whole
        16-byte words)."""
        return -(-self.n * self.stride // 16) * 16


def layout(path: str) -> typing.Optional[Layout]:
    """The record layout of a PLY that K9 decodes, or None for any other
    file (not a PLY, not binary little-endian, vertex element not first,
    list properties, no points, no x/y/z, a record too wide)."""
    if os.path.splitext(path)[1].lower() != ".ply":
        return None
    fmt, elements, offset = loaders._ply_header(path)
    if fmt != "binary_little_endian" or not elements \
            or elements[0][0] != "vertex":
        return None
    _, n, props = elements[0]
    types = dict(p for p in props if p[0] != "__list__")
    names = [p[0] for p in props]
    if n <= 0 or len(types) != len(props) or len(set(names)) != len(names) \
            or not all(t in loaders._PLY_DTYPES for t in types.values()) \
            or not {"x", "y", "z"} <= set(names):
        return None
    dtype = np.dtype([(name, "<" + loaders._PLY_DTYPES[t])
                      for name, t in props])
    if records_a_block(dtype.itemsize) == 0:
        return None
    triple = next((tr for tr in loaders._COLOR_TRIPLES
                   if all(c in types for c in tr)), None)
    normals = all(c in types for c in ("nx", "ny", "nz"))
    wanted = ["x", "y", "z", *(triple or [None] * 3),
              *(("nx", "ny", "nz") if normals else [None] * 3)]
    fields = tuple(
        -1 if name is None else dtype.fields[name][1] << 3
        | _TYPES[loaders._PLY_DTYPES[types[name]]]
        for name in wanted)
    scale = _SCALES.get(types[triple[0]], 0) if triple else 0
    return Layout(path, n, offset, dtype, fields, scale, triple is not None,
                  normals)


def read_records(lay: Layout) -> torch.Tensor:
    """The vertex block, read into a page-locked uint8 buffer of
    ``lay.buffer_bytes``."""
    need = lay.n * lay.stride
    buf = torch.empty(lay.buffer_bytes, dtype=torch.uint8, pin_memory=True)
    with open(lay.path, "rb") as f:
        f.seek(lay.offset)
        got = f.readinto(memoryview(buf.numpy())[:need])
    if got < need:
        raise ValueError(f"{lay.path}: truncated PLY body")
    return buf


def decode_records(records: torch.Tensor, lay: Layout, pad: int):
    """(pad, 3) float32 points, colours and normals (None where the file
    has none) and a one-element int32 tensor of flag bits, from a uint8
    buffer of ``lay``'s records on ``records``' device: K9 on the current
    stream of a CUDA device, ``decode_reference`` elsewhere. On CUDA the
    buffer must be contiguous uint8, 16-byte aligned and at least
    ``lay.buffer_bytes`` long (as ``read_records`` makes it), or this
    raises. Each launch adds one to ``decode_records.launches``."""
    if records.device.type != "cuda":
        return decode_reference(records, lay, pad)
    if pad < lay.n:
        raise ValueError(f"pad_to={pad} < n={lay.n}")
    if records.dtype != torch.uint8 or not records.is_contiguous() \
            or records.data_ptr() % 16 or records.numel() < lay.buffer_bytes:
        raise ValueError(
            f"K9 takes a contiguous uint8 buffer of {lay.buffer_bytes} bytes "
            f"or more at a 16-byte aligned address; got {records.dtype}, "
            f"{records.numel()} bytes, contiguous {records.is_contiguous()}, "
            f"address mod 16 = {records.data_ptr() % 16}")
    from ..ops.refine import _launch

    dev = records.device

    def out(wanted):
        return torch.empty((pad, 3), dtype=torch.float32,
                           device=dev) if wanted else None

    points, colors, normals = out(True), out(lay.colors), out(lay.normals)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    _launch("ply_decode", dev, [records, points, colors, normals, flags],
            [*lay.fields, lay.scale, lay.n, pad, lay.stride])
    decode_records.launches += 1
    return points, colors, normals, flags[:1]


decode_records.launches = 0


def _column(rows: torch.Tensor, code: int) -> torch.Tensor:
    """One field of every record, widened to float64 exactly."""
    offset, kind = code >> 3, code & 7
    size = (1, 1, 2, 2, 4, 4, 4, 8)[kind]
    raw = rows[:, offset:offset + size].contiguous()
    view = (torch.int8, torch.uint8, torch.int16, torch.int16, torch.int32,
            torch.int32, torch.float32, torch.float64)[kind]
    col = raw.view(view).reshape(-1)
    if kind == 3:  # ushort: int16 bits, read unsigned
        col = col.to(torch.int32) & 0xFFFF
    elif kind == 5:  # uint: int32 bits, read unsigned
        col = col.to(torch.int64) & 0xFFFFFFFF
    return col.to(torch.float64)


def _neg_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0) & torch.signbit(x)


def decode_reference(records: torch.Tensor, lay: Layout, pad: int):
    """K9 in plain PyTorch, on any device: ``decode_records``' results."""
    if pad < lay.n:
        raise ValueError(f"pad_to={pad} < n={lay.n}")
    n = lay.n
    rows = records[:n * lay.stride].view(n, lay.stride)

    def stack(codes):
        return torch.stack([_column(rows, c) for c in codes], dim=1)

    def padded(values, fill):
        buf = torch.full((pad, 3), fill, dtype=torch.float32,
                         device=records.device)
        buf[:n] = values
        return buf

    bits = 0
    p64 = stack(lay.fields[:3])
    p32 = p64.to(torch.float32)
    integer = torch.round(p64) == p64  # half to even, as rint
    if not bool((integer & (p64.abs() <= MXU_EXACT_MAX_COORD)).all()):
        bits |= NOT_MXU
    if not bool((p32.to(torch.float64) == p64).all()):
        bits |= NOT_F32
    if not bool((integer & (p64.abs() <= THIN_I16_MAX)).all()):
        bits |= NOT_I16
    if bool(_neg_zero(p32).any()):
        bits |= POINT_NEG_ZERO
    colors = normals = None
    if lay.colors:
        c64 = stack(lay.fields[3:6])
        if lay.scale:
            # tensor / tensor: a true division (torch may turn a division
            # by a scalar into a product with its reciprocal)
            c64 = c64 / torch.full_like(c64, _DIVISORS[lay.scale])
        c32 = c64.to(torch.float32)
        r = torch.round(c64 * 255.0)
        u8 = ~(r < 0) & ~(r > 255) & (r / torch.full_like(r, 255.0) == c64)
        if not bool(u8.all()):
            bits |= NOT_U8
        if bool(_neg_zero(c32).any()):
            bits |= COLOR_NEG_ZERO
        if not bits & NOT_U8 and bits & COLOR_NEG_ZERO:
            c32 = torch.where(_neg_zero(c32), torch.zeros_like(c32), c32)
        colors = padded(c32, 0.0)
    if not bits & NOT_I16 and bits & POINT_NEG_ZERO:
        p32 = torch.where(_neg_zero(p32), torch.zeros_like(p32), p32)
    if lay.normals:
        normals = padded(stack(lay.fields[6:]).to(torch.float32), 0.0)
    flags = torch.tensor([bits], dtype=torch.int32, device=records.device)
    return padded(p32, PAD_SENTINEL), colors, normals, flags


class Staged(typing.NamedTuple):
    """A PLY's vertex block in page-locked host memory, bound for
    ``device``."""

    layout: Layout
    records: torch.Tensor
    device: torch.device

    def host_points(self) -> np.ndarray:
        """The (N, 3) float64 points, as ``read_point_cloud`` gives them."""
        lay = self.layout
        data = np.frombuffer(self.records.numpy(), dtype=lay.dtype,
                             count=lay.n)
        return loaders._ply_points(lay.path, data, lay.dtype.names)

    def upload(self, pad_to: typing.Optional[int] = None,
               points: typing.Optional[np.ndarray] = None) -> Cloud:
        """The padded Cloud (``pad_to`` or the cloud's own bucket): the
        records copied to the card as they are and split there (the span
        ``pcc.decode.device``), then the flags read back, which waits for
        both on this thread's stream. ``points`` are its float64 points
        where the caller has them; otherwise a cloud on the card keeps
        float64 points only where float32 cannot hold them."""
        lay = self.layout
        pad = pad_to if pad_to is not None else pad_bucket(lay.n, "auto")
        cuda = self.device.type == "cuda"
        with span("pcc.decode.device"), (
                torch.cuda.device(self.device) if cuda
                else contextlib.nullcontext()):
            records = self.records.to(self.device, non_blocking=True)
            pts, colors, normals, flags = decode_records(records, lay, pad)
            bits = int(flags.item())
        if points is None and (bits & NOT_F32 or not cuda):
            points = self.host_points()
        return Cloud._decoded(pts, lay.n, colors, normals, points,
                              mxu_exact=not bits & NOT_MXU)


def stage(path: str, dtype: str,
          device: typing.Union[str, torch.device, None]
          ) -> typing.Optional[Staged]:
    """The file's vertex block read into page-locked memory, when the cloud
    is float32 on a CUDA device (``device`` None: the CUDA device, where
    there is one) and ``layout`` accepts the file; else None."""
    if dtype != "float32" or (device is None
                              and not torch.cuda.is_available()):
        return None
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    lay = layout(os.fspath(path))
    return None if lay is None else Staged(lay, read_records(lay), device)
