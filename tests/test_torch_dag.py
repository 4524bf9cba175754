"""PyTorch port: the lazy metric DAG (CloudPair -> MetricCalculator).

``evaluate_pair(engine="dag")`` of the port is held against the JAX
package's DAG on the same numpy clouds over the full option set (ycc and
rgb colour, Hausdorff, point-to-plane in both D2 modes, colour Hausdorff, a
user peak): every PSNR within 1e-4 dB, every other value within 1e-5
relative (the NN results are exact on both sides; the tolerance is for
float32 sums taken in another order). Within the port the DAG must equal
the fused engine, and both must hold the frozen float64 goldens. The
CloudPair accessors, ``get_neighbour_cloud``, the memo, and the pruned
wrappers the DAG uses above the threshold (``nn_pruned``,
``nn_pruned_with_grids``, reached here at small sizes by lowering both
packages' PRUNE_THRESHOLD) are checked against the JAX package too.
"""
import numpy as np
import pytest
import torch

import open_pcc_metric_tpu_torch as P
from open_pcc_metric_tpu_torch.cloud import Cloud, synthetic_voxel_pair
from open_pcc_metric_tpu_torch.cloud_pair import CloudPair, get_neighbour_cloud
from open_pcc_metric_tpu_torch.calculator import MetricCalculator
from open_pcc_metric_tpu_torch.evaluate import evaluate_pair
from open_pcc_metric_tpu_torch.metric import GeoMSE, SymmetricMetric
from open_pcc_metric_tpu_torch.ops import nn as nn_ops
from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_pruned_mod
from open_pcc_metric_tpu_torch.options import CalculateOptions

from test_torch_fused import GOLDENS, PSNR_TOL, _golden_pair, _pair_arrays
from test_torch_nn_brute import _jax_clouds
from test_torch_refine import jax_on_cpu

REL_TOL = 1e-5  # float32 sums in another order, against the JAX package
ENGINE_RTOL = 1e-6  # the port's two engines (tests/test_fuzz.py's bar)

OPTION_SETS = [
    dict(color="ycc", hausdorff=True, point_to_plane=True),
    dict(color="ycc", hausdorff=True, point_to_plane=True,
         d2_mode="pc_error", color_hausdorff=True),
    dict(color="rgb", hausdorff=True, color_hausdorff=True, peak=200.0),
]


def _pair(kw, seed, n=1500):
    """Numpy (points, colours, normals) of a pair for option set ``kw``.
    Reference D2 pairs normals by position in both directions, which the
    DAG (like the reference) allows only for equal point counts; the other
    sets take a pair whose degraded cloud has more points."""
    o, r = _pair_arrays(seed, n=n)
    if kw.get("point_to_plane") and kw.get("d2_mode", "reference") == \
            "reference":
        rng = np.random.default_rng(seed)
        pts1 = o[0] + rng.integers(-1, 2, o[0].shape)
        r = (pts1, np.clip(o[1] + rng.integers(-3, 4, o[1].shape) / 255.0,
                           0, 1), o[2])
    return o, r


def _clouds(o, r, device="cpu"):
    return (Cloud.from_numpy(*o, device=device),
            Cloud.from_numpy(*r, device=device))


def _assert_tables_close(got, want, rtol):
    assert list(got) == list(want)
    for key in want:
        g = np.asarray(got[key], np.float64)
        w = np.asarray(want[key], np.float64)
        if "PSNR" in key[0]:
            assert np.max(np.abs(g - w)) <= PSNR_TOL, (key, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=str(key))


@pytest.mark.parametrize("kw", OPTION_SETS)
def test_dag_matches_jax(kw):
    jax_on_cpu()
    from open_pcc_metric_tpu import CalculateOptions as JOptions
    from open_pcc_metric_tpu.evaluate import evaluate_pair as jevaluate

    o, r = _pair(kw, 21)
    got = evaluate_pair(*_clouds(o, r), CalculateOptions(**kw), engine="dag")
    want = jevaluate(*_jax_clouds(o, r), JOptions(**kw), engine="dag")
    _assert_tables_close(got.as_dict(), want.as_dict(), REL_TOL)
    labels = [tuple(str(v) for v in row[:3])
              for row in want.as_df().values.tolist()]
    assert [row[:3] for row in got.rows()] == labels


@pytest.mark.parametrize("backend", ["auto", "pruned"])
@pytest.mark.parametrize("kw", OPTION_SETS)
def test_dag_equals_fused(kw, backend):
    """The port's two engines give the same table, through the brute
    force (auto on a small pair) and through the pruned search."""
    o, r = _pair(kw, 22)
    opts = CalculateOptions(**kw)
    dag = evaluate_pair(*_clouds(o, r), opts, backend=backend, engine="dag")
    fused = evaluate_pair(*_clouds(o, r), opts, backend=backend,
                          engine="fused")
    _assert_tables_close(dag.as_dict(), fused.as_dict(), ENGINE_RTOL)


def _stat_key(m):
    """The fused-stats / golden key of a table row."""
    child = m.metrics[0] if isinstance(m, SymmetricMetric) else m
    name = type(child).__name__
    if name in ("MinSqrtDistance", "MaxSqrtDistance"):
        return name[:3].lower() + "_sqrt"
    side = "sym" if isinstance(m, SymmetricMetric) else (
        "left" if child.is_left else "right")
    geo = "d2_" if getattr(child, "point_to_plane", False) else "geo_"
    base = {
        "GeoMSE": geo + "mse_", "GeoPSNR": geo + "psnr_",
        "GeoHausdorffDistance": geo + "hausdorff_",
        "GeoHausdorffDistancePSNR": geo + "hausdorff_psnr_",
        "ColorMSE": "color_mse_", "ColorPSNR": "color_psnr_",
        "ColorHausdorffDistance": "color_hausdorff_",
        "ColorHausdorffDistancePSNR": "color_hausdorff_psnr_",
    }[name]
    return base + side


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_dag_matches_goldens(name):
    """Every frozen float64 golden through the DAG engine (float64 clouds,
    brute force), at the bars of tests/test_goldens.py."""
    entry = GOLDENS[name]
    cfg = entry["config"]
    a, b = _golden_pair(cfg)
    opts = CalculateOptions(
        color=cfg["color"], hausdorff=cfg["hausdorff"],
        point_to_plane=cfg["point_to_plane"], d2_mode=cfg["d2_mode"],
        peak=cfg["peak"], color_hausdorff=cfg["color"] is not None)
    res = evaluate_pair(a, b, opts, engine="dag")
    seen = 0
    for m in res._metrics:
        key = _stat_key(m)
        want = np.asarray(entry["metrics"][key], dtype=np.float64)
        ours = np.asarray(m.value, dtype=np.float64)
        tol = PSNR_TOL if "psnr" in key else 1e-5
        rel = np.max(np.abs(ours - want) / np.maximum(np.abs(want), 1e-12))
        assert rel < tol, f"{name}/{key}: ours={ours} golden={want} rel={rel}"
        seen += 1
    assert seen == len(res._metrics) >= 8


def test_memo_is_per_instance():
    """The reference leaks a CLASS-level memo across pairs (SURVEY Q1);
    two pairs here must give different values (tests/test_api.py:64-72)."""
    a1, b1 = synthetic_voxel_pair(500, seed=1, with_colors=False,
                                  device="cpu")
    a2, b2 = synthetic_voxel_pair(500, seed=2, with_colors=False,
                                  device="cpu")
    d1 = evaluate_pair(a1, b1, engine="dag").as_dict()
    d2 = evaluate_pair(a2, b2, engine="dag").as_dict()
    assert d1[("GeoMSE", True, False)] != d2[("GeoMSE", True, False)]


def test_memo_collapses_duplicates():
    a, b = synthetic_voxel_pair(500, seed=1, with_colors=False, device="cpu")
    pair = CloudPair(a, b)
    calc = MetricCalculator(pair)
    m1 = GeoMSE(is_left=True, point_to_plane=False)
    m2 = GeoMSE(is_left=True, point_to_plane=False)
    res = calc.calculate([m1, m2])
    assert res._metrics[0] is res._metrics[1] is m1
    # the diamond: the NN ran once per direction, the boundary never
    assert set(pair._nn_cache) == {0} and pair._boundary_cache is None
    sym = SymmetricMetric([GeoMSE(True, False), GeoMSE(False, False)], False)
    again = calc.calculate([sym])._metrics[0]
    assert set(pair._nn_cache) == {0, 1}
    assert again.value == max(m1.value, calc._calculated_metrics[
        ("GeoMSE", False, False)].value)
    with pytest.raises(ValueError):
        SymmetricMetric(metrics=[GeoMSE(True, False)], is_proportional=True)


def test_cloud_pair_accessors_match_jax():
    """Every CloudPair accessor against the JAX package's on an integer
    pair with colours and file normals: bit for bit, the OBB extent to
    float rounding."""
    jax_on_cpu()
    from open_pcc_metric_tpu.cloud_pair import CloudPair as JCloudPair

    o, r = _pair_arrays(23, n=1000)
    pair = CloudPair(*_clouds(o, r))
    jpair = JCloudPair(*_jax_clouds(o, r))
    for name in ("get_left_error_vector", "get_right_error_vector",
                 "get_left_neighbour_distances",
                 "get_right_neighbour_distances",
                 "get_boundary_sqrt_distances", "get_left_colors",
                 "get_right_colors", "get_left_neighbour_colors",
                 "get_right_neighbour_colors"):
        got = getattr(pair, name)().numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jpair, name)()),
                                      err_msg=name)
    for i in (0, 1):
        np.testing.assert_array_equal(pair.get_cloud_normals(i).numpy(),
                                      np.asarray(jpair.get_cloud_normals(i)))
        np.testing.assert_array_equal(
            pair.get_neighbour_normals(i).numpy(),
            np.asarray(jpair.get_neighbour_normals(i)))
    np.testing.assert_allclose(pair.get_extent(), jpair.get_extent(),
                               rtol=1e-9)
    assert pair.origin_cloud is pair.clouds[0]
    assert pair.reconst_cloud is pair.clouds[1]
    one = CloudPair(Cloud.from_numpy(o[0][:1], device="cpu"), pair.clouds[1])
    with pytest.raises(ValueError):
        one.get_boundary_sqrt_distances()


@pytest.mark.parametrize("n", [0, 2])
def test_get_neighbour_cloud_matches_jax(n):
    jax_on_cpu()
    from open_pcc_metric_tpu.cloud_pair import get_neighbour_cloud as jget

    o, r = _pair_arrays(24, n=900)
    a, b = _clouds(o, r)
    neigh, d = get_neighbour_cloud(a, b, n=n)
    ja, jb = _jax_clouds(o, r)
    jneigh, jd = jget(ja, jb, n=n)
    assert neigh.device == a.device and neigh.n == a.n
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(neigh.points.numpy(),
                                  np.asarray(jneigh.points))
    np.testing.assert_array_equal(neigh.colors.numpy(),
                                  np.asarray(jneigh.colors))
    # the n-th neighbour: n + 1 points of b lie within its distance
    pts_a, pts_b = o[0], r[0]
    dist = ((pts_a[:, None, :] - pts_b[None]) ** 2).sum(-1)
    assert np.all((dist <= d[:, None]).sum(1) >= n + 1)
    with pytest.raises(ValueError):
        get_neighbour_cloud(a, b, n=-1)


def test_pruned_wrappers_match_jax(monkeypatch):
    """Above a lowered PRUNE_THRESHOLD the dispatcher and the DAG go
    through nn_pruned and nn_pruned_with_grids; from a tiny base rung both
    escalate to the same certified rung as the JAX package's nn_pruned,
    with bit-identical results on an integer pair."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu import CalculateOptions as JOptions
    from open_pcc_metric_tpu.evaluate import evaluate_pair as jevaluate
    from open_pcc_metric_tpu.ops import nn as jnn
    from open_pcc_metric_tpu.ops import nn_pruned as jnn_pruned

    monkeypatch.setattr(nn_ops, "PRUNE_THRESHOLD", 1024)
    monkeypatch.setattr(jnn, "PRUNE_THRESHOLD", 1024)
    monkeypatch.setattr(nn_pruned_mod, "_ESCALATION_MEMO", {})
    monkeypatch.setattr(jnn_pruned, "_ESCALATION_MEMO", {})
    rng = np.random.default_rng(25)
    pa = rng.integers(0, 512, (2000, 3)).astype(np.float64)
    pb = rng.integers(0, 512, (2800, 3)).astype(np.float64)
    a = Cloud.from_numpy(pa, device="cpu")
    b = Cloud.from_numpy(pb, device="cpu")
    ja = jnp.asarray(a.points.numpy())
    jb = jnp.asarray(b.points.numpy())
    brute_i, brute_d = nn_ops.nn_chunked(a.points, b.points)

    idx, d = nn_pruned_mod.nn_pruned(a.points, b.points, a.n, b.n, cap=1,
                                     fallback_tiles=1)
    jidx, jd = jnn_pruned.nn_pruned(ja, jb, a.n, b.n, cap=1, fallback_tiles=1)
    np.testing.assert_array_equal(idx[: a.n].numpy(), np.asarray(jidx)[: a.n])
    np.testing.assert_array_equal(d[: a.n].numpy(), np.asarray(jd)[: a.n])
    assert torch.equal(idx[: a.n], brute_i[: a.n])
    assert nn_pruned_mod._ESCALATION_MEMO == jnn_pruned._ESCALATION_MEMO
    (rung, _), = nn_pruned_mod._ESCALATION_MEMO.values()
    assert rung != (1, 1)  # it escalated

    ga, gb = a.get_grid(), b.get_grid()
    gi, gd = nn_pruned_mod.nn_pruned_with_grids(ga, gb, a.n, cap=1,
                                                fallback_tiles=1)
    assert torch.equal(gi[: a.n], idx[: a.n]) and torch.equal(gd, d)
    si, sd = nn_ops.nearest_neighbors(a.points, a.points, exclude_self=True,
                                      n_a=a.n, n_b=a.n, grids=(ga, ga))
    sji, sjd = jnn.nearest_neighbors(ja, ja, exclude_self=True, n_a=a.n,
                                     n_b=a.n)
    np.testing.assert_array_equal(si[: a.n].numpy(), np.asarray(sji)[: a.n])
    np.testing.assert_array_equal(sd[: a.n].numpy(), np.asarray(sjd)[: a.n])

    o, r = _pair_arrays(26, n=1500)
    kw = dict(color="ycc", hausdorff=True, point_to_plane=True,
              d2_mode="pc_error")
    pair = CloudPair(*_clouds(o, r))
    got = MetricCalculator(pair).calculate(
        P.transform_options(CalculateOptions(**kw)))
    assert pair.clouds[0]._grid is not None  # the pruned search ran
    want = jevaluate(*_jax_clouds(o, r), JOptions(**kw), engine="dag")
    _assert_tables_close(got.as_dict(), want.as_dict(), REL_TOL)


def test_library_device_defaults_to_cuda(tmp_path):
    """A library entry point called with no device runs on the CUDA device,
    and raises where there is none instead of running on the CPU (the
    CLI's --device default, tests/test_torch_fused.py)."""
    p = str(tmp_path / "x.ply")
    P.write_ply(p, np.arange(30.0).reshape(10, 3))
    pts = np.arange(30.0).reshape(10, 3)
    calls = [
        lambda: Cloud.from_numpy(pts),
        lambda: P.load_cloud(p),
        lambda: P.synthetic_voxel_pair(100),
        lambda: P.synthetic_sphere_pair(100),
        lambda: P.evaluate_files(p, p),
    ]
    if torch.cuda.is_available():
        assert Cloud.from_numpy(pts).device.type == "cuda"
        assert P.load_cloud(p).device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert Cloud.from_numpy(pts, device="cpu").device.type == "cpu"
