"""The frozen reference and data against brute force NumPy and the
port's originals, at a few thousand points."""
import numpy as np
import pytest

from portbench.data import generate
from portbench.reference import obb, oracle


def _lattice(n, seed, side=14):
    """Integer points with many equal distances (ties everywhere)."""
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, side, (n, 3)), axis=0).astype(float)
    return pts[rng.permutation(len(pts))]


def _brute_nn(a, b, exclude_self=False):
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    if exclude_self:
        np.fill_diagonal(d, np.inf)
    return d.argmin(1), d.min(1)  # argmin: lowest index among ties


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_nn_matches_brute_force_lowest_index_on_ties(seed, exclude_self):
    a = _lattice(2500, seed)
    b = a if exclude_self else _lattice(1800, seed + 10)
    idx, d = oracle.nn(a, b, exclude_self=exclude_self, workers=1)
    want_i, want_d = _brute_nn(a, b, exclude_self)
    np.testing.assert_array_equal(idx, want_i)
    np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("seed", [2, 3])
def test_knn_sets_match_brute_force_lowest_indices_on_ties(seed):
    a = _lattice(2000, seed)
    got = oracle.knn(a, a, 30, workers=1)
    d = ((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)
    ids = np.broadcast_to(np.arange(len(a)), d.shape)
    want = np.lexsort((ids, d), axis=1)[:, :30]
    assert all(set(x) == set(y) for x, y in zip(got, want))


def test_pca_normals_match_brute_force():
    a = generate.voxel_surface(3000, 256, 4)[0]
    got = oracle.pca_normals(a, oracle.F64, workers=1)
    d = ((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)
    ids = np.broadcast_to(np.arange(len(a)), d.shape)
    nb = a[np.lexsort((ids, d), axis=1)[:, :30]]
    c = nb - nb.mean(1, keepdims=True)
    want = np.linalg.eigh(np.einsum("nki,nkj->nij", c, c) / 30)[1][:, :, 0]
    np.testing.assert_allclose(np.abs((got * want).sum(1)), 1.0, atol=1e-9)


def test_table_follows_the_reference_formulas():
    rng = np.random.default_rng(5)
    a, b = _lattice(1500, 6), _lattice(1200, 7)
    ca, cb = rng.integers(0, 256, a.shape) / 255, rng.integers(0, 256,
                                                              b.shape) / 255
    opts = {"color": "ycc", "hausdorff": True, "point_to_plane": True,
            "d2_mode": "pc_error", "peak": 1023.0}
    s = oracle.searches(a, b, workers=1)
    t = oracle.table(a, b, ca, cb, None, None, opts, s, workers=1)
    ia, da = _brute_nn(a, b)
    ib, db = _brute_nn(b, a)
    assert t["geo_mse_left"] == pytest.approx(da.mean(), rel=1e-12)
    assert t["geo_psnr_right"] == pytest.approx(
        10 * np.log10(1023.0 ** 2 / db.mean()), rel=1e-12)
    assert t["geo_hausdorff_sym"] == max(da.max(), db.max())
    ta, tb = ca @ oracle.RGB_TO_YCC.T, cb @ oracle.RGB_TO_YCC.T
    np.testing.assert_allclose(t["color_mse_left"],
                               ((ta - tb[ia]) ** 2).mean(0), rtol=1e-12)
    nb = oracle.pca_normals(b, oracle.F64, workers=1)
    p = (((a - b[ia]) * nb[ia]).sum(1)) ** 2
    assert t["d2_mse_left"] == pytest.approx(p.mean(), rel=1e-9)
    assert t["min_sqrt"] == np.sqrt(_brute_nn(a, a, True)[1].min())


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obb_extent_of_a_rotated_box_beats_a_rotation_sweep(seed):
    rng = np.random.default_rng(seed)
    sides = np.array([300.0, 170.0, 60.0])
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], dtype=float) * sides
    inner = rng.uniform(0, 1, (500, 3)) * sides
    rot = _rotation(seed)
    pts = np.concatenate([corners, inner]) @ rot.T + 500.0
    ext = obb.minimal_obb_extent(pts)
    np.testing.assert_allclose(np.sort(ext), np.sort(sides), rtol=1e-9)
    sweep = min(np.prod(np.ptp(pts @ _rotation(100 + i).T, axis=0))
                for i in range(300))
    assert np.prod(ext) <= sweep * (1 + 1e-9)


def test_tf32_keeps_ten_mantissa_bits_ties_to_even():
    x = np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
                  1023.0, 1 / 255], dtype=np.float64)
    got = oracle.tf32(x).astype(np.float64)
    np.testing.assert_array_equal(
        got[:5], [1.0, 1 + 2.0 ** -10, 1.0, 1 + 2.0 ** -9, 1023.0])
    assert abs(got[5] - 1 / 255) <= (1 / 255) * 2.0 ** -11


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_frozen_generators_equal_the_ports_bit_for_bit(seed):
    from open_pcc_metric_tpu_torch import datasets

    a = generate.voxel_surface(20000, 1024, seed)
    b = datasets.voxel_surface(20000, 1024, seed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for qp in (4, 6, 12, 34, 36):
        x = generate.degrade_gpcc_like(a[0], a[1], qp, seed)
        y = datasets.degrade_gpcc_like(b[0], b[1], qp, seed)
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])


def test_frozen_ply_writer_equals_the_ports(tmp_path):
    from open_pcc_metric_tpu_torch.io import write_ply

    pts, col, nrm = generate.voxel_surface(3000, 1024, 3)
    for normals in (nrm, None):
        generate.write_ply(str(tmp_path / "a.ply"), pts, col, normals)
        write_ply(str(tmp_path / "b.ply"), pts, colors=col, normals=normals)
        assert (tmp_path / "a.ply").read_bytes() == \
            (tmp_path / "b.ply").read_bytes()
