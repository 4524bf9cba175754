"""Host-side point-cloud IO: PLY (ascii/binary), PCD (ascii/binary), PTS, XYZ.

Role parity: the reference delegates to ``o3d.io.read_point_cloud``
(reference: open_pcc_metric/handler.py:57). Semantics reproduced here:
  * points returned as float64 (N, 3),
  * uchar colour properties are normalised to [0, 1] by /255 (Open3D convention),
  * normals are returned when present,
  * real-world PLY layouts accepted: vertex element not first (preceding
    elements skipped, including binary list rows), list properties inside
    the vertex element (skipped per row), trailing elements ignored.

The binary-PLY fast path is a single ``np.frombuffer`` over a structured dtype
(near-memcpy speed); an optional native C parser for huge ASCII files lives in
the package's ``native`` module and is used automatically when built.
"""
from __future__ import annotations

import dataclasses
import os
import typing

import numpy as np


@dataclasses.dataclass
class RawCloud:
    """Host-side (un-padded) cloud straight from disk."""

    points: np.ndarray  # (N, 3) float64
    colors: typing.Optional[np.ndarray] = None  # (N, 3) float64 in [0, 1]
    normals: typing.Optional[np.ndarray] = None  # (N, 3) float64

    @property
    def n(self) -> int:
        return self.points.shape[0]


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_COLOR_TRIPLES = [("red", "green", "blue"), ("r", "g", "b"),
                  ("diffuse_red", "diffuse_green", "diffuse_blue")]


def read_point_cloud(path: typing.Union[str, os.PathLike]) -> RawCloud:
    """Read a point cloud by extension (.ply, .pcd, .pts, .xyz/.xyzrgb/.txt)."""
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return _read_ply(path)
    if ext == ".pcd":
        return _read_pcd(path)
    if ext == ".pts":
        return _read_pts(path)
    if ext in (".xyz", ".xyzrgb", ".xyzn", ".txt"):
        return _read_xyz(path, ext)
    raise ValueError(f"unsupported point-cloud format: {ext!r}")


def _read_point_cloud_staged(
        path: typing.Union[str, os.PathLike],
        on_points: typing.Callable[[np.ndarray], None]) -> RawCloud:
    """``read_point_cloud``, handing the (N, 3) float64 points to
    ``on_points`` the moment they exist: a PLY's before its colours and
    normals are assembled, any other format's once it is read. The points
    are the array the returned ``RawCloud`` holds."""
    path = os.fspath(path)
    if os.path.splitext(path)[1].lower() == ".ply":
        return _read_ply(path, on_points)
    raw = read_point_cloud(path)
    on_points(raw.points)
    return raw


# --------------------------------------------------------------------------- PLY


def _ply_header(path: str):
    """A PLY's header: its format, its elements as [name, count, props]
    (each prop (name, type) or ('__list__', count type, item type, name))
    and the body's byte offset."""
    with open(path, "rb") as f:
        header_lines = []
        line = f.readline()
        if line.strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            sline = line.strip().decode("ascii", errors="replace")
            if sline == "end_header":
                break
            header_lines.append(sline)
        body_offset = f.tell()

    elements: list = []  # (name, count, [(prop_name, dtype_str)|('__list__', ...)])
    for sline in header_lines:
        parts = sline.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if not elements:
                raise ValueError(f"{path}: property before element")
            if parts[1] == "list":
                elements[-1][2].append(("__list__", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))

    if fmt is None:
        raise ValueError(f"{path}: PLY header missing format")
    return fmt, elements, body_offset


def _read_ply(path: str, on_points=None) -> RawCloud:
    fmt, elements, body_offset = _ply_header(path)
    vtx = next((e for e in elements if e[0] == "vertex"), None)
    if vtx is None:
        raise ValueError(f"{path}: PLY has no vertex element")
    vtx_i = elements.index(vtx)
    _, count, props = vtx
    has_list = any(p[0] == "__list__" for p in props)
    scalar_props = [p for p in props if p[0] != "__list__"]

    if fmt != "ascii" and vtx_i == 0 and not has_list:
        # Bounded fast path (the overwhelmingly common layout): vertex is
        # the first element with scalar props only, so read EXACTLY its
        # bytes — a mesh PLY's face data after the vertices (often larger
        # than the vertices themselves) is never pulled into memory.
        endian = "<" if fmt == "binary_little_endian" else ">"
        np_dtype = np.dtype(
            [(name, endian + _PLY_DTYPES[t]) for name, t in props])
        need = np_dtype.itemsize * count
        with open(path, "rb") as f:
            f.seek(body_offset)
            blob = f.read(need)
        if len(blob) < need:
            raise ValueError(f"{path}: truncated PLY body")
        data = np.frombuffer(blob, dtype=np_dtype, count=count)
        names = [p[0] for p in scalar_props]
        types = {p[0]: p[1] for p in scalar_props}
        return _assemble_ply_cloud(path, data, names, types, on_points)

    with open(path, "rb") as f:
        f.seek(body_offset)
        blob = f.read()

    if fmt == "ascii":
        # Skip rows of elements declared before vertex (one text row each).
        pos = 0
        for e in elements[:vtx_i]:
            for _ in range(e[1]):
                nl = blob.find(b"\n", pos)
                if nl < 0:
                    raise ValueError(f"{path}: truncated PLY body")
                pos = nl + 1
        if has_list:
            data = _read_ply_ascii_vertices_with_lists(
                blob[pos:], count, props, path)
        else:
            data = _read_ply_ascii_vertices(path, blob[pos:], count, props)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        pos = 0
        for e in elements[:vtx_i]:
            pos = _skip_ply_binary_element(blob, pos, e, endian, path)
        if has_list:
            data = _read_ply_binary_vertices_with_lists(
                blob, pos, count, props, endian, path)
        else:
            np_dtype = np.dtype(
                [(name, endian + _PLY_DTYPES[t]) for name, t in props])
            if len(blob) - pos < np_dtype.itemsize * count:
                raise ValueError(f"{path}: truncated PLY body")
            data = np.frombuffer(blob, dtype=np_dtype, count=count,
                                 offset=pos)

    names = [p[0] for p in scalar_props]
    types = {p[0]: p[1] for p in scalar_props}
    return _assemble_ply_cloud(path, data, names, types, on_points)


def _ply_points(path, data, names) -> np.ndarray:
    """The (N, 3) float64 points of a PLY's vertex columns."""
    for ax in ("x", "y", "z"):
        if ax not in names:
            raise ValueError(f"{path}: vertex element missing '{ax}'")
    return np.stack([np.asarray(data[ax], dtype=np.float64)
                     for ax in ("x", "y", "z")], axis=1)


def _assemble_ply_cloud(path, data, names, types, on_points=None) -> RawCloud:
    """Columns -> RawCloud with the reference's colour conventions;
    ``on_points`` (where given) gets the points before the colours and
    normals are stacked."""

    def col(name):
        return np.asarray(data[name], dtype=np.float64)

    points = _ply_points(path, data, names)
    if on_points is not None:
        on_points(points)

    colors = None
    for triple in _COLOR_TRIPLES:
        if all(c in names for c in triple):
            colors = np.stack([col(c) for c in triple], axis=1)
            if types[triple[0]] in ("uchar", "uint8"):
                colors = colors / 255.0
            elif types[triple[0]] in ("ushort", "uint16"):
                colors = colors / 65535.0
            break

    normals = None
    if all(c in names for c in ("nx", "ny", "nz")):
        normals = np.stack([col("nx"), col("ny"), col("nz")], axis=1)

    return RawCloud(points=points, colors=colors, normals=normals)


def _read_ply_ascii_vertices(path, body, count, props):
    """List-free vertex rows: one flat numeric scan (native fast path)."""
    ncols = len(props)
    # Native fast path: scan exactly count*ncols numbers from the body
    # (anything after the vertex rows — faces etc. — is ignored).
    from .. import native

    flat = native.parse_floats(body, count * ncols)
    if flat is not None:
        rows = flat.reshape(count, ncols)
    else:
        rows = np.loadtxt(body.decode("ascii", errors="replace").splitlines(),
                          dtype=np.float64, max_rows=count, ndmin=2)
        if rows.shape[0] != count or rows.shape[1] < ncols:
            raise ValueError(f"{path}: ASCII PLY vertex parse mismatch "
                             f"(got {rows.shape}, want ({count},{ncols}))")
    names = [p[0] for p in props]
    return {name: rows[:, i] for i, name in enumerate(names)}


def _read_ply_ascii_vertices_with_lists(body, count, props, path):
    """Vertex rows containing list properties: per-row token walk.

    Column indices are data-dependent when a list sits between scalars, so
    each row is parsed prop-by-prop (slow path — list-in-vertex is rare;
    matches o3d's acceptance of such files, reference handler.py:57).
    """
    out = {p[0]: np.empty(count, dtype=np.float64)
           for p in props if p[0] != "__list__"}
    lines = body.splitlines()
    if len(lines) < count:
        raise ValueError(f"{path}: truncated PLY body")
    for r in range(count):
        toks = lines[r].split()
        i = 0
        try:
            for p in props:
                if p[0] == "__list__":
                    i += 1 + int(float(toks[i]))  # count token + members
                else:
                    out[p[0]][r] = float(toks[i])
                    i += 1
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"{path}: malformed PLY vertex row {r}: {e}") from e
        if i > len(toks):  # trailing list declared more members than present
            raise ValueError(
                f"{path}: malformed PLY vertex row {r}: "
                f"{len(toks)} tokens, {i} expected")
    return out


def _skip_ply_binary_element(blob, pos, element, endian, path):
    """Byte offset just past a binary element's rows (vertex-not-first)."""
    _, count, props = element
    lists = [p for p in props if p[0] == "__list__"]
    if not lists:
        row = sum(np.dtype(_PLY_DTYPES[t]).itemsize for _, t in props)
        end = pos + row * count
        if end > len(blob):
            raise ValueError(f"{path}: truncated PLY body")
        return end
    # List rows have data-dependent sizes: walk row by row.
    for _ in range(count):
        for p in props:
            if p[0] == "__list__":
                cdt = np.dtype(endian + _PLY_DTYPES[p[1]])
                if pos + cdt.itemsize > len(blob):
                    raise ValueError(f"{path}: truncated PLY body")
                k = int(np.frombuffer(blob, cdt, 1, pos)[0])
                pos += cdt.itemsize + k * np.dtype(_PLY_DTYPES[p[2]]).itemsize
            else:
                pos += np.dtype(_PLY_DTYPES[p[1]]).itemsize
        if pos > len(blob):
            raise ValueError(f"{path}: truncated PLY body")
    return pos


def _read_ply_binary_vertices_with_lists(blob, pos, count, props, endian,
                                         path):
    """Binary vertex rows containing list properties: per-row walk."""
    out = {p[0]: np.empty(count, dtype=np.float64)
           for p in props if p[0] != "__list__"}
    for r in range(count):
        for p in props:
            if p[0] == "__list__":
                cdt = np.dtype(endian + _PLY_DTYPES[p[1]])
                if pos + cdt.itemsize > len(blob):
                    raise ValueError(f"{path}: truncated PLY body")
                k = int(np.frombuffer(blob, cdt, 1, pos)[0])
                pos += cdt.itemsize + k * np.dtype(_PLY_DTYPES[p[2]]).itemsize
            else:
                dt = np.dtype(endian + _PLY_DTYPES[p[1]])
                if pos + dt.itemsize > len(blob):
                    raise ValueError(f"{path}: truncated PLY body")
                out[p[0]][r] = np.frombuffer(blob, dt, 1, pos)[0]
                pos += dt.itemsize
    return out


def write_ply(
    path: typing.Union[str, os.PathLike],
    points: np.ndarray,
    colors: typing.Optional[np.ndarray] = None,
    normals: typing.Optional[np.ndarray] = None,
    binary: bool = True,
    color_uchar: bool = True,
) -> None:
    """Write a PLY file (used by tests and dataset tooling)."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    n = points.shape[0]
    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    header_props = ["property double x", "property double y", "property double z"]
    if normals is not None:
        fields += [("nx", "<f8"), ("ny", "<f8"), ("nz", "<f8")]
        header_props += [f"property double n{a}" for a in "xyz"]
    if colors is not None:
        if color_uchar:
            fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            header_props += [f"property uchar {c}" for c in ("red", "green", "blue")]
        else:
            fields += [("red", "<f4"), ("green", "<f4"), ("blue", "<f4")]
            header_props += [f"property float {c}" for c in ("red", "green", "blue")]
    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points.T
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float64).reshape(-1, 3)
        rec["nx"], rec["ny"], rec["nz"] = normals.T
    if colors is not None:
        colors = np.asarray(colors, dtype=np.float64).reshape(-1, 3)
        if color_uchar:
            c8 = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
            rec["red"], rec["green"], rec["blue"] = c8.T
        else:
            rec["red"], rec["green"], rec["blue"] = colors.astype(np.float32).T

    fmt = "binary_little_endian" if binary else "ascii"
    header = "\n".join(
        ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
        + header_props
        + ["end_header", ""]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            widths = points
            cols = [points]
            if normals is not None:
                cols.append(normals)
            if colors is not None:
                cols.append(
                    np.clip(np.round(colors * 255.0), 0, 255)
                    if color_uchar else colors
                )
            mat = np.concatenate(cols, axis=1)
            if colors is not None and color_uchar:
                ncoord = mat.shape[1] - 3
                fmts = ["%.10g"] * ncoord + ["%d"] * 3
            else:
                fmts = ["%.10g"] * mat.shape[1]
            np.savetxt(f, mat, fmt=" ".join(fmts).split())


# --------------------------------------------------------------------------- PCD


_PCD_TYPE = {("F", 4): "f4", ("F", 8): "f8",
             ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
             ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """Decompress a liblzf stream (PCD ``binary_compressed`` bodies).

    The stream is a sequence of control bytes: ctrl < 32 starts a literal
    run of ctrl+1 bytes; otherwise the top 3 bits are a match length
    (7 ⇒ one extension byte follows) and the remaining 13 bits (5 high +
    next byte) encode the back-reference distance − 1. Matches may
    overlap their own output (run-length-style), handled by pattern
    replication. Parity surface: ``o3d.io.read_point_cloud`` reads these
    files via PCL's liblzf (reference handler.py:57).
    """
    out = bytearray(expected)
    i, o, n = 0, 0, len(data)
    try:
        while i < n:
            ctrl = data[i]
            i += 1
            if ctrl < 32:  # literal run of ctrl+1 bytes
                run = ctrl + 1
                if i + run > n or o + run > expected:
                    raise ValueError("literal run overflows")
                out[o:o + run] = data[i:i + run]
                i += run
                o += run
            else:  # back-reference
                length = ctrl >> 5
                if length == 7:
                    length += data[i]
                    i += 1
                length += 2
                ref = o - (((ctrl & 0x1F) << 8) | data[i]) - 1
                i += 1
                if ref < 0 or o + length > expected:
                    raise ValueError("back-reference out of range")
                if ref + length <= o:
                    out[o:o + length] = out[ref:ref + length]
                else:  # overlapping: replicate the available pattern
                    span = o - ref
                    reps = -(-length // span)
                    out[o:o + length] = (bytes(out[ref:o]) * reps)[:length]
                o += length
    except IndexError as e:  # ran off the end of `data`
        raise ValueError("truncated LZF stream") from e
    if o != expected:
        raise ValueError(
            f"LZF stream produced {o} bytes, header declared {expected}")
    return bytes(out)


def _lzf_compress(data: bytes) -> bytes:
    """Greedy liblzf-format compressor (used by ``write_pcd`` and tests).

    Emits literal runs (≤32) and back-references (length ≤ 264,
    distance ≤ 8192) — the exact stream grammar `_lzf_decompress`
    accepts, and PCL's decompressor too.
    """
    n = len(data)
    out = bytearray()
    htab: dict = {}
    lit_start = 0
    i = 0

    def flush(end: int, start: int) -> None:
        while start < end:
            run = min(32, end - start)
            out.append(run - 1)
            out.extend(data[start:start + run])
            start += run

    while i + 2 < n:
        key = bytes(data[i:i + 3])
        ref = htab.get(key, -1)
        htab[key] = i
        dist = i - ref - 1
        if ref >= 0 and dist < 8192:
            maxlen = min(n - i, 264)
            length = 3
            while length < maxlen and data[ref + length] == data[i + length]:
                length += 1
            flush(i, lit_start)
            enc = length - 2
            if enc < 7:
                out.append((enc << 5) | (dist >> 8))
            else:
                out.append((7 << 5) | (dist >> 8))
                out.append(enc - 7)
            out.append(dist & 0xFF)
            i += length
            lit_start = i
        else:
            i += 1
    flush(n, lit_start)
    return bytes(out)


def _read_pcd(path: str) -> RawCloud:
    header: dict = {}
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated PCD header")
            s = line.decode("ascii", errors="replace").strip()
            if s.startswith("#") or not s:
                continue
            key, _, rest = s.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        body = f.read()

    fields = header["FIELDS"]
    sizes = list(map(int, header["SIZE"]))
    types = header["TYPE"]
    counts = list(map(int, header.get("COUNT", ["1"] * len(fields))))
    npts = int(header["POINTS"][0])
    mode = header["DATA"][0].lower()

    cols = []
    for name, size, typ, cnt in zip(fields, sizes, types, counts):
        for k in range(cnt):
            cname = name if cnt == 1 else f"{name}_{k}"
            cols.append((cname, "<" + _PCD_TYPE[(typ, size)]))

    if mode == "binary":
        dtype = np.dtype(cols)
        data = np.frombuffer(body, dtype=dtype, count=npts)
    elif mode == "binary_compressed":
        # PCL layout: u32 compressed size, u32 uncompressed size, then an
        # LZF stream of the data in field-major (SOA) order — each field's
        # npts×(size·count) bytes contiguous.
        import struct

        if len(body) < 8:
            raise ValueError(f"{path}: truncated binary_compressed PCD")
        comp_size, uncomp_size = struct.unpack("<II", body[:8])
        if len(body) < 8 + comp_size:
            raise ValueError(f"{path}: binary_compressed body shorter than "
                             "its declared compressed size")
        raw = _lzf_decompress(body[8:8 + comp_size], uncomp_size)
        data = {}
        off = 0
        ci = 0
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            block = np.frombuffer(
                raw, dtype="<" + _PCD_TYPE[(typ, size)],
                count=npts * cnt, offset=off)
            off += size * cnt * npts
            if cnt == 1:
                data[cols[ci][0]] = block
            else:
                block = block.reshape(npts, cnt)
                for k in range(cnt):
                    data[cols[ci + k][0]] = block[:, k]
            ci += cnt
    elif mode == "ascii":
        rows = np.loadtxt(body.decode("ascii").splitlines(), dtype=np.float64,
                          max_rows=npts, ndmin=2)
        data = {name: rows[:, i] for i, (name, _) in enumerate(cols)}
    else:
        raise ValueError(f"{path}: PCD DATA mode {mode!r} unsupported")

    def col(name, dtype=np.float64):
        return np.asarray(data[name], dtype=dtype)

    points = np.stack([col("x"), col("y"), col("z")], axis=1)

    colors = None
    names = [c[0] for c in cols]
    if "rgb" in names or "rgba" in names:
        key = "rgb" if "rgb" in names else "rgba"
        if mode != "ascii":
            packed = np.asarray(data[key]).view(np.uint32) if np.asarray(
                data[key]).dtype.kind == "u" else np.asarray(
                data[key]).astype(np.float32).view(np.uint32)
        else:
            packed = np.asarray(data[key], dtype=np.float32).view(np.uint32)
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        colors = np.stack([r, g, b], axis=1).astype(np.float64) / 255.0
    elif all(c in names for c in ("r", "g", "b")):
        colors = np.stack([col("r"), col("g"), col("b")], axis=1) / 255.0

    normals = None
    if all(c in names for c in ("normal_x", "normal_y", "normal_z")):
        normals = np.stack(
            [col("normal_x"), col("normal_y"), col("normal_z")], axis=1)

    # Drop NaN rows (PCD convention for invalid points in organised clouds).
    good = np.isfinite(points).all(axis=1)
    if not good.all():
        points = points[good]
        colors = colors[good] if colors is not None else None
        normals = normals[good] if normals is not None else None
    return RawCloud(points=points, colors=colors, normals=normals)


def write_pcd(
    path: typing.Union[str, os.PathLike],
    points: np.ndarray,
    colors: typing.Optional[np.ndarray] = None,
    normals: typing.Optional[np.ndarray] = None,
    mode: str = "binary",
) -> None:
    """Write a PCD v0.7 file (``ascii`` | ``binary`` | ``binary_compressed``).

    PCL conventions: f32 coordinates, colours packed into one f32 ``rgb``
    field (u32 0x00RRGGBB bit pattern), compressed bodies stored
    field-major (SOA) under LZF.
    """
    if mode not in ("ascii", "binary", "binary_compressed"):
        raise ValueError(f"unknown PCD mode {mode!r}")
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    fields, sizes, types, counts = ["x", "y", "z"], [4] * 3, ["F"] * 3, [1] * 3
    columns = [points[:, 0], points[:, 1], points[:, 2]]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        fields += ["normal_x", "normal_y", "normal_z"]
        sizes += [4] * 3
        types += ["F"] * 3
        counts += [1] * 3
        columns += [normals[:, 0], normals[:, 1], normals[:, 2]]
    if colors is not None:
        c8 = np.clip(np.round(np.asarray(colors, dtype=np.float64)
                              .reshape(-1, 3) * 255.0), 0, 255).astype(np.uint32)
        packed = ((c8[:, 0] << 16) | (c8[:, 1] << 8) | c8[:, 2]).astype(np.uint32)
        fields.append("rgb")
        sizes.append(4)
        types.append("F")
        counts.append(1)
        columns.append(packed.view(np.float32))
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
        "SIZE " + " ".join(map(str, sizes)),
        "TYPE " + " ".join(types),
        "COUNT " + " ".join(map(str, counts)),
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {mode}",
        "",
    ])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if mode == "ascii":
            # PCL prints packed rgb as its float32 value; 9 significant
            # digits round-trip every float32 (incl. the denormal-range
            # packed-rgb bit patterns).
            mat = np.stack([c.astype(np.float32) for c in columns], axis=1)
            np.savetxt(f, mat.astype(np.float64), fmt="%.9g")
        elif mode == "binary":
            rec = np.empty(n, dtype=np.dtype(
                [(name, "<f4") for name in fields]))
            for name, col in zip(fields, columns):
                rec[name] = col
            f.write(rec.tobytes())
        else:  # binary_compressed: SOA under LZF
            import struct

            raw = b"".join(
                np.ascontiguousarray(col, dtype="<f4").tobytes()
                for col in columns)
            comp = _lzf_compress(raw)
            f.write(struct.pack("<II", len(comp), len(raw)))
            f.write(comp)


# --------------------------------------------------------------------------- XYZ


def _read_pts(path: str) -> RawCloud:
    """.pts scanner export: optional leading count line, then
    ``x y z [intensity] [r g b]`` rows (o3d-compatible surface —
    reference handler.py:57 accepts whatever o3d reads)."""
    with open(path, "rb") as f:
        first = f.readline().decode("ascii", errors="replace").split()
        rest = f.read()
    declared = None
    if len(first) == 1:
        try:
            declared = int(first[0])
            first = []
        except ValueError:
            pass
    lines = rest.decode("ascii", errors="replace").splitlines()
    if first:
        lines.insert(0, " ".join(first))
    mat = np.loadtxt(lines, dtype=np.float64, ndmin=2,
                     max_rows=declared if declared is not None else None)
    if mat.size == 0:
        raise ValueError(f"{path}: empty .pts file")
    if declared is not None and mat.shape[0] != declared:
        raise ValueError(
            f"{path}: .pts declares {declared} points, found {mat.shape[0]}")
    points = mat[:, :3]
    colors = None
    if mat.shape[1] >= 7:  # x y z intensity r g b
        colors = mat[:, 4:7]
    elif mat.shape[1] == 6:  # x y z r g b
        colors = mat[:, 3:6]
    # .pts colours are documented as 0-255 integers; an all-integral
    # channel set normalises even when every value happens to be <= 1
    # (near-black scans would otherwise decode 255x brighter than an
    # identical file with one brighter pixel).
    if colors is not None and (
        colors.max() > 1.0
        or (np.array_equal(colors, np.round(colors)) and colors.max() >= 0)
    ):
        colors = np.clip(colors / 255.0, 0.0, 1.0)
    return RawCloud(points=points, colors=colors, normals=None)


def _read_xyz(path: str, ext: str) -> RawCloud:
    mat = np.loadtxt(path, dtype=np.float64, ndmin=2)
    points = mat[:, :3]
    colors = None
    normals = None
    if ext == ".xyzrgb" and mat.shape[1] >= 6:
        colors = mat[:, 3:6]
        if colors.max() > 1.0:
            colors = colors / 255.0
    elif ext == ".xyzn" and mat.shape[1] >= 6:
        normals = mat[:, 3:6]
    elif mat.shape[1] >= 6:
        colors = mat[:, 3:6]
        if colors.max() > 1.0:
            colors = colors / 255.0
    return RawCloud(points=points, colors=colors, normals=normals)


def point_count(path: typing.Union[str, os.PathLike]) -> int:
    """Number of points in a cloud file, from the header when possible.

    PLY ('element vertex N') and PCD ('POINTS N') expose the count in their
    headers, so sweep planning (batch.run_sweep's common pad bucket) can
    size its buffers without parsing bodies; XYZ-family files fall back to
    a full read.
    """
    path = os.fspath(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        with open(path, "rb") as f:
            for raw in iter(f.readline, b""):
                parts = raw.decode("ascii", "replace").split()
                if parts[:2] == ["element", "vertex"] and len(parts) >= 3:
                    return int(parts[2])
                if parts[:1] == ["end_header"]:
                    break
        raise ValueError(f"no 'element vertex' in PLY header: {path}")
    if ext == ".pcd":
        with open(path, "rb") as f:
            for raw in iter(f.readline, b""):
                line = raw.decode("ascii", "replace").strip()
                if line.startswith("POINTS"):
                    return int(line.split()[1])
                if line.startswith("DATA"):
                    break
        raise ValueError(f"no 'POINTS' in PCD header: {path}")
    if ext == ".pts":
        with open(path, "rb") as f:
            first = f.readline().decode("ascii", "replace").split()
        if len(first) == 1:
            try:
                return int(first[0])
            except ValueError:
                pass
    return read_point_cloud(path).n
