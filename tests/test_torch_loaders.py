"""PyTorch port: the copied ``io/`` loaders against the JAX package's.

Mirrors ``tests/test_loaders.py`` (PLY layouts with elements before the
vertices and list properties, ``.pts`` variants, malformed headers, PCD in
all three encodings with its LZF codec) and the two ``point_count`` tests
of ``tests/test_batch.py``. Every file is read by both packages: the port
returns the JAX package's arrays bit for bit, or raises ``ValueError``
where JAX does. The sweep's parse stage and common pad bucket rest on
these functions.
"""
import struct

import numpy as np
import pytest

from open_pcc_metric_tpu_torch.io import (point_count, read_point_cloud,
                                          write_pcd, write_ply)
from open_pcc_metric_tpu_torch.io.loaders import (_lzf_compress,
                                                  _lzf_decompress)

from test_torch_refine import jax_on_cpu

PTS0 = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])


def _jax_io():
    jax_on_cpu()
    from open_pcc_metric_tpu import io as jio

    return jio


def _header(lines):
    return ("ply\n" + "\n".join(lines) + "\nend_header\n").encode("ascii")


def _read_both(path):
    """The port's RawCloud, after holding it equal to JAX's."""
    got, want = read_point_cloud(path), _jax_io().read_point_cloud(path)
    assert got.n == want.n
    for name in ("points", "colors", "normals"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def _ascii_pre_vertex():
    body = "9 9 9\n8 8 8\n" + "".join(f"{x:g} {y:g} {z:g}\n"
                                      for x, y, z in PTS0)
    return _header([
        "format ascii 1.0", "element other 2",
        "property float foo", "property float bar", "property float baz",
        "element vertex 3",
        "property float x", "property float y", "property float z",
    ]) + body.encode()


def _binary_pre_vertex():
    return _header([
        "format binary_little_endian 1.0", "element other 2",
        "property float a", "property float b", "property float c",
        "element vertex 3",
        "property float x", "property float y", "property float z",
    ]) + struct.pack("<6f", *range(6)) + PTS0.astype("<f4").tobytes()


def _binary_after_list_element():
    """Faces before vertices: list rows have data-dependent sizes."""
    faces = (struct.pack("<B3i", 3, 0, 1, 2)
             + struct.pack("<B4i", 4, 0, 1, 2, 3))
    return _header([
        "format binary_little_endian 1.0", "element face 2",
        "property list uchar int vertex_indices", "element vertex 3",
        "property float x", "property float y", "property float z",
    ]) + faces + PTS0.astype("<f4").tobytes()


def _ascii_list_inside_vertex():
    """A list between scalar props makes column indices data-dependent."""
    rows = ["0 0 0 2 7 7 255 0 0", "1 2 3 0 0 255 0",
            "4 5 6 3 1 2 3 0 0 255"]
    return _header([
        "format ascii 1.0", "element vertex 3",
        "property float x", "property float y", "property float z",
        "property list uchar int segments",
        "property uchar red", "property uchar green", "property uchar blue",
    ]) + ("\n".join(rows) + "\n").encode()


def _binary_list_inside_vertex():
    body = b""
    for (x, y, z), lst in zip(PTS0, [[7, 7], [], [1, 2, 3]]):
        body += struct.pack("<3f", x, y, z)
        body += struct.pack(f"<B{len(lst)}i", len(lst), *lst)
        body += struct.pack("<f", 0.5)
    return _header([
        "format binary_little_endian 1.0", "element vertex 3",
        "property float x", "property float y", "property float z",
        "property list uchar int segments", "property float quality",
    ]) + body


def _faces_after_vertex():
    """The common mesh layout (vertices then faces) keeps the fast path."""
    body = "".join(f"{x:g} {y:g} {z:g}\n" for x, y, z in PTS0) + "3 0 1 2\n"
    return _header([
        "format ascii 1.0", "element vertex 3",
        "property float x", "property float y", "property float z",
        "element face 1", "property list uchar int vertex_indices",
    ]) + body.encode()


@pytest.mark.parametrize("make", [
    _ascii_pre_vertex, _binary_pre_vertex, _binary_after_list_element,
    _ascii_list_inside_vertex, _binary_list_inside_vertex,
    _faces_after_vertex], ids=lambda f: f.__name__.strip("_"))
def test_ply_layouts(tmp_path, make):
    p = tmp_path / "a.ply"
    p.write_bytes(make())
    raw = _read_both(p)
    np.testing.assert_allclose(raw.points, PTS0)
    if make is _ascii_list_inside_vertex:
        np.testing.assert_allclose(
            raw.colors, np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1.0]]))
    assert point_count(p) == 3


@pytest.mark.parametrize("with_count", [True, False])
@pytest.mark.parametrize("ncols", [3, 4, 6, 7])
def test_pts_variants(tmp_path, with_count, ncols):
    p = tmp_path / "f.pts"
    extra = {3: "", 4: " 42", 6: " 255 128 0", 7: " 42 255 128 0"}[ncols]
    body = "".join(f"{x:g} {y:g} {z:g}{extra}\n" for x, y, z in PTS0)
    p.write_text((f"{len(PTS0)}\n" if with_count else "") + body)
    raw = _read_both(p)
    np.testing.assert_allclose(raw.points, PTS0)
    if ncols >= 6:
        np.testing.assert_allclose(raw.colors[0], [1.0, 128 / 255.0, 0.0])
    else:
        assert raw.colors is None
    assert point_count(p) == _jax_io().point_count(p) == 3


def _truncated_pcd(tmp_path):
    p = tmp_path / "t.pcd"
    write_pcd(p, PTS0, mode="binary_compressed")
    return p.read_bytes()[:-3]


@pytest.mark.parametrize("name,content", [
    # property before any element
    ("bad.ply", _header(["format ascii 1.0", "property float x"])),
    # no vertex element at all
    ("bad.ply", _header(["format ascii 1.0", "element face 0",
                         "property list uchar int vertex_indices"])),
    # missing format line
    ("bad.ply", _header(["element vertex 1", "property float x",
                         "property float y", "property float z"])
     + b"0 0 0\n"),
    # vertex missing a coordinate property
    ("bad.ply", _header(["format ascii 1.0", "element vertex 1",
                         "property float x", "property float y"]) + b"0 0\n"),
    # truncated binary body
    ("bad.ply", _header(["format binary_little_endian 1.0",
                         "element vertex 4", "property float x",
                         "property float y", "property float z"])
     + b"\x00" * 12),
    # truncated binary pre-vertex list element
    ("bad.ply", _header(["format binary_little_endian 1.0",
                         "element face 3",
                         "property list uchar int vertex_indices",
                         "element vertex 1", "property float x",
                         "property float y", "property float z"])
     + struct.pack("<B3i", 3, 0, 1, 2)),
    # malformed ascii list row (declared members missing)
    ("bad.ply", _header(["format ascii 1.0", "element vertex 1",
                         "property float x", "property float y",
                         "property float z", "property list uchar int seg"])
     + b"0 0 0 5 1\n"),
    ("bad.ply", b"solid nope\n"),  # not a PLY
    ("bad.ply", b"ply\nformat ascii 1.0\nelement vertex 3\n"),  # no end
    ("bad.pts", b"5\n0 0 0\n1 1 1\n"),  # count mismatch
    ("t.pcd", _truncated_pcd),  # truncated binary_compressed body
], ids=["property-first", "no-vertex", "no-format", "no-z", "short-body",
        "short-list-element", "short-list-row", "not-a-ply",
        "no-end-header", "pts-count", "pcd-truncated"])
def test_malformed_raises_valueerror(tmp_path, name, content):
    p = tmp_path / name
    p.write_bytes(content(tmp_path) if callable(content) else content)
    with pytest.raises(ValueError):
        read_point_cloud(p)
    with pytest.raises(ValueError):
        _jax_io().read_point_cloud(p)


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
@pytest.mark.parametrize("with_payload", [True, False])
def test_pcd_roundtrip(tmp_path, mode, with_payload):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(257, 3)) * 100.0
    col = rng.integers(0, 256, size=(257, 3)) / 255.0
    nrm = rng.normal(size=(257, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    p, jp = tmp_path / "r.pcd", tmp_path / "j.pcd"
    kw = dict(colors=col if with_payload else None,
              normals=nrm if with_payload else None, mode=mode)
    write_pcd(p, pts, **kw)
    _jax_io().write_pcd(jp, pts, **kw)
    assert p.read_bytes() == jp.read_bytes()
    raw = _read_both(p)
    np.testing.assert_allclose(raw.points, pts.astype(np.float32), rtol=1e-6)
    if with_payload:
        np.testing.assert_allclose(raw.colors, col, atol=1e-12)
        np.testing.assert_allclose(raw.normals, nrm.astype(np.float32),
                                   rtol=1e-6)
    else:
        assert raw.colors is None and raw.normals is None
    assert point_count(p) == 257


def test_pcd_compressed_matches_binary(tmp_path):
    """binary_compressed decodes to bit-identical arrays vs plain binary."""
    rng = np.random.default_rng(11)
    # Voxelised coords: repeated float values make the LZF stream take
    # real back-references, not just literal runs.
    pts = np.round(rng.normal(size=(1000, 3)) * 8.0)
    col = rng.integers(0, 4, size=(1000, 3)) / 255.0
    pb, pc = tmp_path / "b.pcd", tmp_path / "c.pcd"
    write_pcd(pb, pts, colors=col, mode="binary")
    write_pcd(pc, pts, colors=col, mode="binary_compressed")
    assert pc.stat().st_size < pb.stat().st_size  # it actually compressed
    rb, rc = _read_both(pb), _read_both(pc)
    np.testing.assert_array_equal(rb.points, rc.points)
    np.testing.assert_array_equal(rb.colors, rc.colors)


def test_lzf_stream_fuzz():
    jax_on_cpu()
    from open_pcc_metric_tpu.io.loaders import _lzf_compress as jcompress

    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 3, 31, 32, 33, 300, 5000):
        for alphabet in (2, 256):
            raw = bytes(rng.integers(0, alphabet, size=n, dtype=np.uint8))
            packed = _lzf_compress(raw)
            assert packed == jcompress(raw)
            assert _lzf_decompress(packed, n) == raw
    # long self-overlapping run (RLE-style back-reference)
    raw = b"ab" * 4000 + b"tail"
    assert _lzf_decompress(_lzf_compress(raw), len(raw)) == raw


def test_lzf_corrupt_raises():
    good = _lzf_compress(b"hello hello hello hello")
    with pytest.raises(ValueError):
        _lzf_decompress(good, 7)  # wrong declared size
    with pytest.raises(ValueError):
        _lzf_decompress(good[:-2], 23)  # truncated stream
    with pytest.raises(ValueError):
        _lzf_decompress(b"\xff\xff", 400)  # back-ref before start


def test_pts_integral_dark_colors_normalised(tmp_path):
    """All-integral .pts colours normalise by 255 even when every value is
    <= 1 (near-black scan)."""
    p = tmp_path / "dark.pts"
    p.write_text("2\n0 0 0 128 1 1 0\n1 0 0 128 0 1 1\n")
    raw = _read_both(p)
    assert raw.colors is not None
    np.testing.assert_allclose(raw.colors.max(), 1.0 / 255.0)


def test_point_count_headers(tmp_path):
    """point_count reads PLY headers without parsing bodies, as JAX's."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 10, (123, 3))
    for binary in (False, True):
        p = tmp_path / f"{binary}.ply"
        write_ply(str(p), pts, binary=binary)
        assert point_count(p) == _jax_io().point_count(p) == 123
        _read_both(p)


def test_point_count_rejects_prefix_element_names(tmp_path):
    """'element vertexfoo 10' must not be read as the vertex count."""
    p = tmp_path / "odd.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertexfoo 10\n"
        "property float x\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "end_header\n"
        + "0 0 0\n1 0 0\n0 1 0\n"
    )
    assert point_count(p) == _jax_io().point_count(p) == 3
