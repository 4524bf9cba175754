"""PyTorch port: the brute-force k-NN kernel K8 (``csrc/knn_brute.cu``)
and its dispatch in ``ops/knn.knn``.

``knn`` runs the plain version ``knn_chunked`` on CPU tensors and K8 on
CUDA tensors, which raises for anything but (N, 3) float32 and
1 <= k <= 32. K8 must return the plain version's rows bit for bit, in
index and distance: the k smallest pairs of the total (squared distance,
row index) order, ``exclude_self``'s pair at FLT_MAX, ``PAD_SENTINEL``
rows as candidates like any other.

On the CPU: that contract, written out in numpy, against ``knn`` (the
reference K8 is held to), the dispatch, the launch counter, and cell 1's
sweep (the common pad calls no brute k-NN). Tests marked ``cuda`` hold the
kernel to ``knn_chunked`` on the card and skip without one.
"""
import importlib

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch import batch
from open_pcc_metric_tpu_torch.cloud import PAD_SENTINEL, Cloud
from open_pcc_metric_tpu_torch.datasets import voxel_surface
from open_pcc_metric_tpu_torch.io import write_ply
from open_pcc_metric_tpu_torch.ops import normals
from open_pcc_metric_tpu_torch.ops.knn import knn, knn_chunked
from open_pcc_metric_tpu_torch.ops.refine import MAX_K

# the module (``ops.knn`` is the function: ops/__init__.py rebinds it)
knn_mod = importlib.import_module("open_pcc_metric_tpu_torch.ops.knn")

SWEEP_KW = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")


def _surface(n, pad_to, seed=0, grid=1024):
    """A voxelised surface of n points in scan order, padded to ``pad_to``
    rows (float32, CPU): integer coordinates, so equal distances abound."""
    pts, _, _ = voxel_surface(n, grid=grid, seed=seed)
    return Cloud.from_numpy(pts, device="cpu", pad_to=pad_to).points


def _jittered(n, pad_to, seed=1):
    pts, _, _ = voxel_surface(n, grid=1024, seed=seed)
    rng = np.random.default_rng(seed)
    pts = pts + rng.uniform(-0.5, 0.5, pts.shape)
    return Cloud.from_numpy(pts, device="cpu", pad_to=pad_to).points


def _shuffled(n, pad_to, seed=2):
    """A voxelised surface on a coarse grid (ties at the k-th distance
    abound) with its rows in random order: neighbours lie in every tile, so
    the walk meets lower rows after higher ones at equal distances."""
    pts = _surface(n, pad_to, seed=seed, grid=64)
    perm = torch.randperm(pts.shape[0],
                          generator=torch.Generator().manual_seed(seed))
    return pts[perm].contiguous()


def _sparse(n_valid, pad_to):
    """Fewer than k valid points among PAD_SENTINEL rows."""
    pts = np.arange(3 * n_valid, dtype=np.float64).reshape(n_valid, 3) % 7
    return Cloud.from_numpy(pts, device="cpu", pad_to=pad_to).points


def _contract(a, b, k, exclude_self):
    """The contract in numpy: float32 squared distances rounded step by
    step as ((dx^2 + dy^2) + dz^2), FLT_MAX on the excluded diagonal, and
    each row's first k pairs of the (d, j) order."""
    diff = a.numpy()[:, None, :] - b.numpy()[None, :, :]
    sq = diff * diff
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    if exclude_self:
        own = np.arange(min(d.shape))
        d[own, own] = np.finfo(np.float32).max
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (torch.from_numpy(order.astype(np.int32)),
            torch.from_numpy(np.take_along_axis(d, order, axis=1)))


def _assert_same(got, want):
    gi, gd = got
    wi, wd = want
    assert gi.dtype == wi.dtype == torch.int32
    assert gd.dtype == wd.dtype
    assert torch.equal(gi.cpu(), wi.cpu())
    assert torch.equal(gd.cpu().view(torch.int32), wd.cpu().view(torch.int32))


CASES = {
    "voxel self": lambda: (_surface(1900, 2048),) * 2,
    "jittered self": lambda: (_jittered(1500, 1536),) * 2,
    "sparse self": lambda: (_sparse(20, 256),) * 2,
    "shuffled self": lambda: (_shuffled(3000, 3072),) * 2,
    "a > b": lambda: (_surface(2500, 2560, seed=3), _surface(700, 768,
                                                             seed=4)),
    "a < b": lambda: (_surface(300, 320, seed=5), _surface(2500, 2560,
                                                           seed=6)),
}


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_knn_keeps_the_total_order(case, exclude_self):
    """knn on the CPU gives the contract's rows bit for bit at k = 30 (the
    estimation's), however many candidates tie and wherever they lie."""
    a, b = CASES[case]()
    if a.shape[0] > 400:
        a = a[:: a.shape[0] // 400].contiguous()  # a spread of query rows
    k = min(30, b.shape[0])
    _assert_same(knn(a, b, k, exclude_self), _contract(a, b, k, exclude_self))


@pytest.mark.parametrize("k", [1, 2, 8, 32])
def test_cpu_knn_other_k(k):
    a = _surface(1200, 1280, seed=7)
    q = a[::5].contiguous()
    _assert_same(knn(q, a, k), _contract(q, a, k, False))


def test_cpu_dispatch_runs_the_plain_version():
    """CPU tensors, float64 and k > 32 run knn_chunked, and no call counts
    a launch; the positional chunk checks stay."""
    a = _surface(500, 512)
    before = knn.launches
    for pts, k in ((a, 30), (a.double(), 30), (a, MAX_K + 1), (a, MAX_K)):
        _assert_same(knn(pts, pts, k), knn_chunked(pts, pts, k))
        _assert_same(knn(pts, pts, k, True), knn_chunked(pts, pts, k, True))
    assert knn.launches == before
    with pytest.raises(ValueError):
        knn(a, a, 30, False, 0)
    with pytest.raises(ValueError):
        knn(a[:10], a[:10], 30)


def test_estimate_normals_cloud_takes_the_dispatch():
    """Below 65536 rows the estimation runs its 30-NN through ops.knn.knn,
    and its normals equal those of knn_chunked's sets."""
    pts, _, _ = voxel_surface(3000, grid=1024, seed=2)
    cloud = Cloud.from_numpy(pts, device="cpu")
    idx, _ = knn_chunked(cloud.points, cloud.points, 30)
    want = normals.normals_from_neighbors(cloud.points, idx, 30,
                                          n_valid=cloud.n)
    got = normals.estimate_normals_cloud(cloud)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.fixture
def sweep_frames(tmp_path):
    """A reference of 1500 points and three smaller degraded frames, no
    normals on either side."""
    rng = np.random.default_rng(0)
    odir, pdir = tmp_path / "orig", tmp_path / "proc"
    odir.mkdir()
    pdir.mkdir()
    pts = np.unique(rng.integers(0, 128, (1500, 3)), axis=0).astype(float)
    for f, keep in enumerate((600, 400, 200)):
        write_ply(odir / f"frame{f}.ply", pts, colors=rng.random(pts.shape))
        sub = pts[:keep] + rng.integers(-1, 2, (keep, 3))
        write_ply(pdir / f"frame{f}.ply", sub, colors=rng.random(sub.shape))
    return batch.pairs_from_dirs(str(odir), str(pdir))


def _sweep_brute_calls(items, journal, pad, device, monkeypatch):
    """(knn_chunked calls, K8 launches) in one run_sweep, with the pruning
    threshold at 1024 rows, so the reference (1536 rows) is pruned: cell
    1's shape, where the common pad is its 800k reference's. Every call of
    ops.knn.knn is one or the other."""
    monkeypatch.setattr(normals, "_PRUNE_THRESHOLD", 1024)
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return knn_chunked(*args, **kw)

    monkeypatch.setattr(knn_mod, "knn_chunked", spy)
    before = knn.launches
    out = batch.run_sweep(items, str(journal), pad=pad, device=device,
                          **SWEEP_KW)
    assert all("error" not in r for r in out)
    return len(calls), knn.launches - before


def test_common_pad_sweep_calls_no_brute_knn(sweep_frames, tmp_path,
                                            monkeypatch):
    """Cell 1's path: with the common pad every cloud takes the pruned
    k-NN, so run_sweep never calls ops.knn.knn; per-pair buckets do."""
    assert _sweep_brute_calls(sweep_frames, tmp_path / "c.jsonl", "common",
                              "cpu", monkeypatch) == (0, 0)
    calls, launches = _sweep_brute_calls(sweep_frames, tmp_path / "p.jsonl",
                                         "per-pair", "cpu", monkeypatch)
    assert calls > 0 and launches == 0


# ------------------------------------------------------------------ card


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K8 kernel has no CPU mode")
    return torch.device("cuda")


def _check_on_card(a, b, k, exclude_self, dev):
    qa, qb = a.to(dev), b.to(dev)
    before = knn.launches
    got = knn(qa, qb, k, exclude_self)
    assert knn.launches == before + 1
    _assert_same(got, knn_chunked(qa, qb, k, exclude_self))


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("rows", [1024, 3584, 14336, 57344])
def test_cuda_voxel_self_matches_plain(rows, exclude_self):
    """Voxelised integer clouds full of equal distances, k = 30, at the
    padded sizes of the cells' brute-path frames."""
    dev = _cuda_or_skip()
    a = _surface(rows - rows // 40, rows, seed=rows)
    _check_on_card(a, a, 30, exclude_self, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("case", ["jittered", "shuffled", "sparse"])
def test_cuda_float_and_sparse_match_plain(case, exclude_self):
    """A jittered float cloud, a shuffled one (ties met out of row order),
    and fewer than k valid points among PAD_SENTINEL rows (the sets hold
    sentinel rows, as the sort's do)."""
    dev = _cuda_or_skip()
    a = {"jittered": lambda: _jittered(14000, 14336),
         "shuffled": lambda: _shuffled(14000, 14336),
         "sparse": lambda: _sparse(20, 1024)}[case]()
    _check_on_card(a, a, 30, exclude_self, dev)
    assert case != "sparse" or bool((a[20:] == PAD_SENTINEL).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 8, 30, 32])
@pytest.mark.parametrize("shape", ["a>b", "a<b"])
def test_cuda_cross_shapes_and_k(shape, k):
    """a != b, as the ring's shards and get_nearest_neighbor (k = n + 1)
    give them, at every k the tests name."""
    dev = _cuda_or_skip()
    big, small = _surface(14000, 14336, seed=11), _surface(3500, 3584, seed=12)
    a, b = (big, small) if shape == "a>b" else (small, big)
    _check_on_card(a, b, k, False, dev)


@pytest.mark.cuda
def test_cuda_dispatch_and_counter():
    """One launch a call on the card; float64, k outside [1, 32], shapes
    other than (N, 3) and mixed dtypes raise there and launch nothing:
    no CUDA call reaches the plain version."""
    dev = _cuda_or_skip()
    a = _surface(3500, 3584).to(dev)
    before = knn.launches
    knn(a, a, 30)
    knn(a, a, 5, True)
    assert knn.launches == before + 2
    bad = [(a.double(), a.double(), 30), (a, a, MAX_K + 1), (a, a, 0),
           (a[:, :2], a[:, :2], 30), (a, a.double(), 30),
           (a[:10], a[:10], 30)]
    for qa, qb, k in bad:
        with pytest.raises(ValueError):
            knn(qa, qb, k)
    assert knn.launches == before + 2


@pytest.mark.cuda
def test_cuda_estimation_56k_matches_plain(monkeypatch):
    """estimate_normals_cloud on a 56k-point cloud (57344 rows, the QP 18
    frame's size) through K8 gives the plain path's normals bit for bit."""
    dev = _cuda_or_skip()
    pts, _, _ = voxel_surface(56000, grid=1024, seed=18)
    cloud = Cloud.from_numpy(pts, device=dev)
    assert cloud.padded_size == 57344
    before = knn.launches
    got = normals.estimate_normals_cloud(cloud)
    assert knn.launches == before + 1
    monkeypatch.setattr(knn_mod, "knn", knn_chunked)
    want = normals.estimate_normals_cloud(
        Cloud.from_numpy(pts, device=dev))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_common_pad_sweep_launches_no_k8(sweep_frames, tmp_path,
                                             monkeypatch):
    """Cell 1's path on the card: the common pad launches K8 zero times;
    per-pair buckets launch it for the small frames."""
    dev = _cuda_or_skip()
    assert _sweep_brute_calls(sweep_frames, tmp_path / "c.jsonl", "common",
                              dev, monkeypatch) == (0, 0)
    calls, launches = _sweep_brute_calls(sweep_frames, tmp_path / "p.jsonl",
                                         "per-pair", dev, monkeypatch)
    assert calls == 0 and launches > 0
