"""PyTorch port: binary PLY records decoded on the card (K9,
``io/ply_decode.py``, ``csrc/ply_decode.cu``) against the host path.

A float32 load onto a CUDA device of a binary little-endian PLY whose
vertex element comes first with scalar properties only uploads the raw
records and splits them with K9; the device must hold the bits the host
path (``read_point_cloud`` and ``Cloud.from_numpy`` with the thin upload)
uploads. On the CPU, K9's plain version (``decode_reference``) is held to
``Cloud.from_numpy(read_point_cloud(path))`` on every accepted layout, and
every other layout of ``test_torch_loaders.py`` must keep the host path;
it is held to the JAX package's own load of each file too. The ``cuda``
tests hold K9 itself to the host path, from the kernel up to
a ``fused_evaluate`` table and a ``run_sweep`` journal.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from open_pcc_metric_tpu_torch import evaluate as evaluate_mod
from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.io import ply_decode, read_point_cloud
from open_pcc_metric_tpu_torch.io.ply_decode import NOT_F32, NOT_MXU
from open_pcc_metric_tpu_torch.utils import profiling

from test_torch_loaders import (_ascii_list_inside_vertex, _ascii_pre_vertex,
                                _binary_after_list_element,
                                _binary_list_inside_vertex,
                                _binary_pre_vertex, _faces_after_vertex,
                                _header)
from test_torch_refine import jax_on_cpu

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device: the K9 kernel "
                                "has no CPU mode")

# (x/y/z type, integer coordinates); the colour and normal choices below
XYZ = [("f8", True), ("f8", False), ("f4", True), ("f4", False),
       ("i4", True), ("i2", True)]
COLORS = [None, "u1", "u2"]
PLY_TYPES = {"f8": "double", "f4": "float", "i4": "int", "i2": "short",
             "u1": "uchar", "u2": "ushort", "i1": "char", "u4": "uint"}


def _write(path, fields, columns, n):
    """A binary little-endian PLY of ``fields`` [(name, type)] in that
    order, each column from ``columns``."""
    rec = np.empty(n, dtype=np.dtype([(f, "<" + t) for f, t in fields]))
    for f, _ in fields:
        rec[f] = columns[f]
    header = _header(["format binary_little_endian 1.0",
                      f"element vertex {n}"]
                     + [f"property {PLY_TYPES[t]} {f}" for f, t in fields])
    path.write_bytes(header + rec.tobytes())
    return str(path)


def _cloud_file(tmp_path, xyz, integer, colors, normals, shuffled, seed=0,
                n=3000, wide=False):
    rng = np.random.default_rng(seed)
    pts = rng.integers(-500, 1000, (n, 3)).astype(np.float64)
    if not integer:
        pts += rng.uniform(-0.5, 0.5, pts.shape)
    cols = {a: pts[:, i] for i, a in enumerate("xyz")}
    fields = [(a, xyz) for a in "xyz"]
    if normals:
        nrm = rng.normal(size=(n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        fields += [(f"n{a}", "f8" if seed % 2 else "f4") for a in "xyz"]
        cols.update({f"n{a}": nrm[:, i] for i, a in enumerate("xyz")})
    if colors is not None:
        top = 255 if colors == "u1" else 65535
        c = rng.integers(0, top + 1, (n, 3))
        c[:3] = [[0, 0, 0], [top, top, top], [1, 2, 3]]
        fields += [(ch, colors) for ch in ("red", "green", "blue")]
        cols.update({ch: c[:, i] for i, ch in enumerate(("red", "green",
                                                         "blue"))})
    if shuffled:  # other properties among them, in another order
        cols.update(alpha=rng.integers(0, 256, n),
                    quality=rng.normal(size=n), flag=rng.integers(-9, 9, n))
        fields += [("alpha", "u1"), ("quality", "f4"), ("flag", "i1")]
        fields = [fields[i] for i in rng.permutation(len(fields))]
    if wide:  # a record wider than 192 bytes: fewer records a block
        for k in range(30):
            cols[f"extra{k}"] = rng.normal(size=n)
            fields.append((f"extra{k}", "f8"))
    return _write(tmp_path / "c.ply", fields, cols, n)


def _host_cloud(path, thin, device="cpu", pad_to=None):
    raw = read_point_cloud(path)
    return Cloud.from_numpy(raw.points, raw.colors, raw.normals,
                            pad_to=pad_to, thin=thin, device=device)


def _bits(t):
    return None if t is None else t.view(torch.int32).cpu()


def _assert_same_bits(got, want):
    for name in ("points", "colors", "normals"):
        g, w = _bits(getattr(got, name)), _bits(getattr(want, name))
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.shape == w.shape and torch.equal(g, w), name


def _neg_zeros(t):
    return int(((t == 0) & torch.signbit(t)).sum())


def _records(path, lay):
    """The file's vertex block as a CPU uint8 tensor, 16 bytes over."""
    raw = np.fromfile(path, np.uint8)[lay.offset:lay.offset
                                      + lay.n * lay.stride]
    return torch.cat([torch.from_numpy(raw.copy()),
                      torch.zeros(16, dtype=torch.uint8)])


def _reference_cloud(path):
    """K9's plain version on the file's records, at the host path's pad,
    and its flag bits."""
    lay = ply_decode.layout(path)
    pad = _host_cloud(path, False).padded_size
    pts, col, nrm, flags = ply_decode.decode_reference(
        _records(path, lay), lay, pad)
    return Cloud(points=pts, n=lay.n, colors=col, normals=nrm), int(flags)


LAYOUTS = [(x, integer, c, nrm, sh) for x, integer in XYZ for c in COLORS
           for nrm in (False, True) for sh in (False, True)]
LAYOUT_IDS = [f"{x}{'-int' if i else '-jit'}-{c or 'nocol'}"
              f"{'-nrm' if n else ''}{'-shuf' if s else ''}"
              for x, i, c, n, s in LAYOUTS]


@pytest.mark.parametrize("xyz,integer,colors,normals,shuffled", LAYOUTS,
                         ids=LAYOUT_IDS)
def test_reference_decode_equals_the_host_path(tmp_path, xyz, integer, colors,
                                               normals, shuffled):
    """K9's plain version on the raw records: the points, colours, normals
    and pad rows of ``Cloud.from_numpy(read_point_cloud(path))``, thin or
    wide, bit for bit, and both flags as the host computes them."""
    path = _cloud_file(tmp_path, xyz, integer, colors, normals, shuffled,
                       seed=len(xyz) + 2 * integer + shuffled)
    got, flags = _reference_cloud(path)
    for thin in (True, False):
        want = _host_cloud(path, thin)
        _assert_same_bits(got, want)
    pts = read_point_cloud(path).points
    assert (not flags & NOT_MXU) == want.mxu_exact()
    assert (not flags & NOT_F32) == np.array_equal(
        pts.astype(np.float32).astype(np.float64), pts)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_reference_decode_keeps_colour_and_field_conventions(tmp_path, wide):
    """Float colours, the ``r g b`` and ``diffuse_*`` triples, a first
    channel's type picking the scale of all three, every scalar type."""
    rng = np.random.default_rng(5)
    n = 2000
    pts = rng.integers(0, 1024, (n, 3)).astype(np.float64)
    cases = [
        [("x", "u4"), ("y", "i1"), ("z", "u2"),
         ("red", "f4"), ("green", "f4"), ("blue", "f4")],
        [("r", "u1"), ("x", "f8"), ("g", "f8"), ("y", "f8"), ("b", "u1"),
         ("z", "f8")],
        [("x", "i4"), ("y", "i4"), ("z", "i4"), ("diffuse_red", "u2"),
         ("diffuse_green", "u1"), ("diffuse_blue", "f8")],
    ]
    for k, fields in enumerate(cases):
        cols = {"x": pts[:, 0] % 120, "y": pts[:, 1] % 100 - 50,
                "z": pts[:, 2]}
        for f, t in fields:
            if f not in cols:
                cols[f] = (rng.integers(0, 256, n) / 255.0 if t.startswith("f")
                           else rng.integers(0, 256, n))
        if wide:
            for j in range(30):
                cols[f"e{j}"] = rng.normal(size=n)
                fields = fields + [(f"e{j}", "f8")]
        path = _write(tmp_path / f"k{k}.ply", fields, cols, n)
        got, _ = _reference_cloud(path)
        for thin in (True, False):
            _assert_same_bits(got, _host_cloud(path, thin))


def test_reference_decode_clears_negative_zeros_as_the_thin_upload(tmp_path):
    """int16 and uint8 hold no -0.0: where the thin upload takes a narrow
    array, a -0.0 coordinate or colour arrives as +0.0, and K9 follows it
    (the wide upload, thin=False, keeps the sign)."""
    n = 600
    rng = np.random.default_rng(2)
    pts = rng.integers(-40, 40, (n, 3)).astype(np.float64)
    pts[5] = [-0.0, 3.0, -0.0]
    col = rng.integers(0, 256, (n, 3)) / 255.0
    col[7] = [-0.0, 0.0, 1.0]
    fields = [("x", "f8"), ("y", "f8"), ("z", "f8"), ("red", "f8"),
              ("green", "f8"), ("blue", "f8")]
    cols = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            "red": col[:, 0], "green": col[:, 1], "blue": col[:, 2]}
    path = _write(tmp_path / "z.ply", fields, cols, n)
    got, _ = _reference_cloud(path)
    _assert_same_bits(got, _host_cloud(path, True))
    assert not _neg_zeros(got.points) and not _neg_zeros(got.colors)
    wide = _host_cloud(path, False)
    assert _neg_zeros(wide.points) == 2 and _neg_zeros(wide.colors) == 1
    # a cloud the thin upload cannot narrow keeps its -0.0
    cols["x"] = cols["x"] + 0.25
    cols["red"] = cols["red"] * 0.5
    cols["y"][5], cols["green"][7] = -0.0, -0.0
    path = _write(tmp_path / "w.ply", fields, cols, n)
    got, _ = _reference_cloud(path)
    _assert_same_bits(got, _host_cloud(path, True))
    assert _neg_zeros(got.points) == 2 and _neg_zeros(got.colors) == 2


@pytest.mark.parametrize("xyz,integer,colors,normals,shuffled", LAYOUTS,
                         ids=LAYOUT_IDS)
def test_reference_decode_equals_the_jax_package(tmp_path, xyz, integer,
                                                 colors, normals, shuffled):
    """K9's plain version against the JAX package's own load of the file:
    its ``read_point_cloud``, cast to float32 and padded by its
    ``Cloud.from_numpy``, thin and wide, bit for bit, pad rows and
    ``mxu_exact`` included. (The ``cuda`` tests hold K9 to this plain
    version; the JAX package does not run on the card.)"""
    jax_on_cpu()
    from open_pcc_metric_tpu import io as jio
    from open_pcc_metric_tpu.cloud import Cloud as JaxCloud

    path = _cloud_file(tmp_path, xyz, integer, colors, normals, shuffled,
                       seed=len(xyz) + 2 * integer + shuffled)
    got, flags = _reference_cloud(path)
    raw = jio.read_point_cloud(path)
    for thin in (True, False):
        want = JaxCloud.from_numpy(raw.points, raw.colors, raw.normals,
                                   pad_to=got.padded_size, thin=thin)
        for name in ("points", "colors", "normals"):
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None), name
            if g is not None:
                w = np.asarray(w)
                assert w.dtype == np.float32 and w.shape == tuple(g.shape)
                assert np.array_equal(g.numpy().view(np.int32),
                                      w.view(np.int32)), name
    assert (not flags & NOT_MXU) == want.mxu_exact()


def _big_endian(tmp_path):
    return _header(["format binary_big_endian 1.0", "element vertex 3",
                    "property float x", "property float y",
                    "property float z"]) + np.arange(9, dtype=">f4").tobytes()


@pytest.mark.parametrize("make", [
    _ascii_pre_vertex, _binary_pre_vertex, _binary_after_list_element,
    _ascii_list_inside_vertex, _binary_list_inside_vertex,
    _faces_after_vertex, _big_endian, "pcd", "no-z"],
    ids=lambda f: f if isinstance(f, str) else f.__name__.strip("_"))
def test_other_layouts_keep_the_host_path(tmp_path, make):
    """Every layout K9 does not take: ``layout`` gives None, so
    ``load_cloud`` reads it on the host as before."""
    from open_pcc_metric_tpu_torch.io import write_pcd

    if make == "pcd":
        path = str(tmp_path / "a.pcd")
        write_pcd(path, np.arange(12.0).reshape(4, 3))
    elif make == "no-z":
        path = _write(tmp_path / "a.ply", [("x", "f4"), ("y", "f4")],
                      {"x": np.ones(3), "y": np.ones(3)}, 3)
    else:
        path = str(tmp_path / "a.ply")
        with open(path, "wb") as f:
            f.write(make() if make is not _big_endian else make(tmp_path))
    assert ply_decode.layout(path) is None


def _padded_record_file(tmp_path, stride, n=700):
    """x, y, z as doubles and ``stride - 24`` uchar fields after them."""
    rng = np.random.default_rng(stride)
    cols = {a: rng.integers(-99, 99, n).astype(float) for a in "xyz"}
    fields = [(a, "f8") for a in "xyz"]
    for k in range(stride - 24):
        cols[f"u{k}"] = np.full(n, k % 256)
        fields.append((f"u{k}", "u1"))
    return _write(tmp_path / f"s{stride}.ply", fields, cols, n)


@pytest.mark.parametrize("stride,per_block", [
    (51, 256), (184, 256), (192, 240), (3008, 16), (3009, 0)])
def test_records_a_block_keeps_a_block_in_shared_memory(tmp_path, stride,
                                                        per_block):
    """256 records a block, or as many as fit 47 KB in a multiple of 16;
    a record too wide for 16 of them keeps the host path."""
    assert ply_decode.records_a_block(stride) == per_block
    lay = ply_decode.layout(_padded_record_file(tmp_path, stride, n=40))
    assert (lay is None) == (per_block == 0)
    if lay is not None:
        assert lay.stride == stride


def test_only_float32_loads_onto_a_card_are_staged(tmp_path):
    path = _cloud_file(tmp_path, "f8", True, "u1", True, False, n=300)
    assert ply_decode.layout(path) is not None
    assert ply_decode.stage(path, "float32", "cpu") is None
    assert ply_decode.stage(path, "float64", "cuda") is None
    assert ply_decode.stage(path, "float64", None) is None


def _cpu_staged(monkeypatch, events):
    """``ply_decode.stage`` staging every accepted file in plain CPU memory
    for the CPU device, so the decode path runs end to end on the CPU;
    ``events`` records the decode."""
    def stage(path, dtype, device):
        lay = ply_decode.layout(path)
        if lay is None or dtype != "float32":
            return None
        buf = torch.zeros(-(-lay.n * lay.stride // 16) * 16,
                          dtype=torch.uint8)
        with open(path, "rb") as f:
            f.seek(lay.offset)
            f.readinto(memoryview(buf.numpy())[:lay.n * lay.stride])
        return ply_decode.Staged(lay, buf, torch.device(device))

    real = ply_decode.decode_records

    def decode(*args):
        events.append("decode")
        return real(*args)

    monkeypatch.setattr(ply_decode, "stage", stage)
    monkeypatch.setattr(ply_decode, "decode_records", decode)


def test_on_points_gets_the_float64_points_before_the_upload(tmp_path,
                                                             monkeypatch):
    events = []
    _cpu_staged(monkeypatch, events)
    path = _cloud_file(tmp_path, "f8", False, "u1", False, True, n=900)
    handed = []

    def on_points(points):
        events.append("points")
        handed.append(points)

    cloud = evaluate_mod._load_cloud(path, "float32", None, "cpu", on_points)
    assert events == ["points", "decode"]
    (points,) = handed
    assert points.dtype == np.float64
    assert np.array_equal(points, read_point_cloud(path).points)
    assert cloud.valid_points() is points
    _assert_same_bits(cloud, _host_cloud(path, True))
    assert cloud.mxu_exact() == _host_cloud(path, True).mxu_exact()


@pytest.mark.parametrize("decoded", [True, False], ids=["decoded", "host"])
def test_load_counts_each_decode_on_the_card_in_its_span(tmp_path,
                                                         monkeypatch, decoded):
    """``pcc.decode.device`` once a decoded load, inside its
    ``pcc.upload``; none on the host path."""
    if decoded:
        _cpu_staged(monkeypatch, [])
    path = _cloud_file(tmp_path, "i2", True, None, False, False, n=500)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                evaluate_mod.load_cloud(path, device="cpu")
        t = profiling.totals(thread=threading.get_native_id())
        inner = profiling.totals(within="pcc.upload")
    finally:
        profiling.reset()
    assert t["pcc.parse"].calls == 2
    assert ("pcc.decode.device" in t) == decoded
    if decoded:
        assert t["pcc.decode.device"].calls == 2
        assert inner["pcc.decode.device"].calls == 2


# ------------------------------------------------------------- on the card


@cuda
@needs_card
@pytest.mark.parametrize("xyz,integer,colors,normals,shuffled", LAYOUTS,
                         ids=LAYOUT_IDS)
def test_kernel_equals_the_host_path(tmp_path, xyz, integer, colors, normals,
                                     shuffled):
    path = _cloud_file(tmp_path, xyz, integer, colors, normals, shuffled,
                       seed=3 + shuffled, wide=xyz == "i2" and shuffled)
    before = ply_decode.decode_records.launches
    got = evaluate_mod.load_cloud(path, pad_to=4096)
    assert ply_decode.decode_records.launches == before + 1
    for thin in (True, False):
        _assert_same_bits(got, _host_cloud(path, thin, "cuda", 4096))
    host = _host_cloud(path, True, "cuda", 4096)
    assert got.mxu_exact() == host.mxu_exact()
    assert np.array_equal(got.valid_points(), host.valid_points())
    lay = ply_decode.layout(path)
    records = _records(path, lay)
    ref = ply_decode.decode_reference(records, lay, 4096)
    dev = ply_decode.decode_records(records.cuda(), lay, 4096)
    for r, d in zip(ref, dev):
        assert (r is None) == (d is None)
        if r is not None:
            assert torch.equal(_bits(r), _bits(d))


@cuda
@needs_card
@pytest.mark.parametrize("bad", ["dtype", "strided", "misaligned", "short"])
def test_kernel_refuses_a_buffer_it_cannot_read(tmp_path, bad):
    """K9 reads whole 16-byte words from the buffer's start: a buffer of
    another dtype, not contiguous, not 16-byte aligned or shorter than
    ``buffer_bytes`` raises before any launch."""
    path = _cloud_file(tmp_path, "f8", True, "u1", True, False, n=4001)
    lay = ply_decode.layout(path)
    assert lay.n * lay.stride % 16  # so the exact size is too short
    records = _records(path, lay).cuda()
    wrong = {
        "dtype": lambda: records.to(torch.int8),
        "strided": lambda: torch.stack([records, records], 1)[:, 0],
        "misaligned": lambda: torch.cat([records[:1], records])[1:],
        "short": lambda: records[:lay.n * lay.stride].clone(),
    }[bad]()
    before = ply_decode.decode_records.launches
    with pytest.raises(ValueError, match="K9 takes"):
        ply_decode.decode_records(wrong, lay, 4096)
    assert ply_decode.decode_records.launches == before
    ply_decode.decode_records(records, lay, 4096)
    assert ply_decode.decode_records.launches == before + 1


@cuda
@needs_card
@pytest.mark.parametrize("stride", [27, 192, 3008])
def test_kernel_takes_every_record_width(tmp_path, stride):
    path = _padded_record_file(tmp_path, stride)
    _assert_same_bits(evaluate_mod.load_cloud(path),
                      _host_cloud(path, True, "cuda"))


@cuda
@needs_card
def test_kernel_clears_negative_zeros_as_the_thin_upload(tmp_path):
    n = 5000
    pts = np.arange(3 * n, dtype=np.float64).reshape(n, 3) % 97 - 48
    pts[4000] = [-0.0, -0.0, 1.0]
    fields = [("x", "f8"), ("y", "f8"), ("z", "f8")]
    path = _write(tmp_path / "z.ply", fields,
                  {a: pts[:, i] for i, a in enumerate("xyz")}, n)
    got = evaluate_mod.load_cloud(path)
    _assert_same_bits(got, _host_cloud(path, True, "cuda"))
    assert not _neg_zeros(got.points)


def _sweep_files(tmp_path, frames=3):
    from open_pcc_metric_tpu_torch.batch import SweepItem
    from open_pcc_metric_tpu_torch.io import write_ply

    rng = np.random.default_rng(11)
    pts = np.unique(rng.integers(0, 256, (6000, 3)), axis=0).astype(float)
    col = rng.integers(0, 256, pts.shape) / 255.0
    ref = str(tmp_path / "ref.ply")
    write_ply(ref, pts, colors=col)
    items = []
    for q in range(frames):
        step = 2 ** q
        fr = np.unique(np.round(pts / step) * step, axis=0)
        fc = rng.integers(0, 256, fr.shape) / 255.0
        p = str(tmp_path / f"f{q}.ply")
        write_ply(p, fr, colors=fc)
        items.append(SweepItem(ref, p, f"q{q}"))
    return ref, items


@cuda
@needs_card
def test_tables_and_journals_equal_the_host_paths(tmp_path, monkeypatch):
    from open_pcc_metric_tpu_torch import batch
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    ref, items = _sweep_files(tmp_path)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    a = evaluate_mod.load_cloud(ref)
    b = evaluate_mod.load_cloud(items[1].pcloud)
    ha, hb = (_host_cloud(p, "auto", "cuda") for p in (ref, items[1].pcloud))
    got, want = fused_evaluate(a, b, **kw), fused_evaluate(ha, hb, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k

    def journal(name):
        recs = batch.run_sweep(items, str(tmp_path / name), resume=False,
                               **kw)
        return [r["metrics"] for r in recs]

    decoded = journal("d.jsonl")
    monkeypatch.setattr(
        batch, "load_cloud",
        lambda path, dtype, pad_to, device: _host_cloud(path, "auto", device,
                                                        pad_to))
    assert journal("h.jsonl") == decoded


@cuda
@needs_card
def test_decode_adds_no_readback_on_the_main_thread(tmp_path):
    path = _cloud_file(tmp_path, "f8", True, "u1", True, False, n=4000)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            cloud = evaluate_mod.load_cloud(path)
            cloud.mxu_exact()
        t = profiling.totals(thread=threading.get_native_id())
    finally:
        profiling.reset()
    assert t["pcc.decode.device"].calls == 1
    assert "pcc.readback" not in t


@cuda
@needs_card
def test_back_to_back_loads_keep_their_own_records(tmp_path):
    """Two loads of same-sized files on one thread, and again on a side
    stream: the second's read into the reused staging buffer never reaches
    the first's copy."""
    paths = []
    for k in range(2):
        d = tmp_path / str(k)
        d.mkdir()
        paths.append(_cloud_file(d, "f8", bool(k), "u1", True, False,
                                 seed=k, n=4000))
    for stream in (None, torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            clouds = [evaluate_mod.load_cloud(p, pad_to=4096) for p in paths]
        torch.cuda.synchronize()
        for p, c in zip(paths, clouds):
            _assert_same_bits(c, _host_cloud(p, True, "cuda", 4096))
