"""PyTorch port: the small-cloud brute-force path (K5) against the JAX package.

On the CPU ``nn_argmin`` runs its plain version ``nn_chunked``; the JAX side
is its own ``nn_chunked`` and the Pallas ``nn_argmin`` in interpret mode.
Integer clouds must agree bit for bit in index and squared distance, ties
to the lowest index. Float clouds follow the rule of test_torch_refine.py,
because XLA:CPU may contract the distance into FMAs where eager PyTorch
does not: d within 4*eps*d, and the index equal on every row whose best and
second-best distances are further apart than that.

The fused evaluation's brute branch (``backend="auto"`` below 65536 padded
rows) is held against the JAX package's ``fused_evaluate`` on the CPU
(each PSNR within 1e-4 dB, MSEs to rtol 1e-6) and against the frozen
float64 goldens. The CUDA kernel itself is checked against ``nn_chunked``
by the tests marked ``cuda`` (skipped without a card) and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.handler import main as cli_main
from open_pcc_metric_tpu_torch.io import write_ply
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import nn as nn_ops
from open_pcc_metric_tpu_torch.ops.fused import (
    boundary_stats, fused_evaluate, pair_stats)
from open_pcc_metric_tpu_torch.ops.nn import (
    nn_argmin, nn_chunked, recompute_dist_sq, resolve_backend)

from test_torch_fused import GOLDENS, PSNR_TOL, _golden_pair, _pair_arrays
from test_torch_refine import assert_float_agree, jax_on_cpu

MSE_RTOL = 1e-6  # float32 sums of the same exact NN terms in another order
# Values that are one exact NN distance (no sum, no projection, no colour
# transform, where XLA:CPU may contract into FMAs): equal bit for bit.
EXACT_KEYS = {"n_a", "n_b", "d1_max_l", "d1_max_r", "self_min", "self_max"}


def _points(kind, n, seed, hi=512):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, hi, (n, 3)).astype(np.float64)
    return rng.uniform(0.0, hi, (n, 3))


def _padded(pts, **kw):
    return Cloud.from_numpy(pts, device="cpu", **kw).points


def _jax_nn(a, b, exclude_self=False, **kw):
    """The JAX package's nn_chunked (idx, d) and Pallas nn_argmin idx
    (interpret mode) on the same padded float32 rows."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.nn import nn_chunked as jchunked
    from open_pcc_metric_tpu.ops.nn_pallas import nn_argmin as jargmin

    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    ji, jd = jchunked(ja, jb, exclude_self=exclude_self, **kw)
    pi = jargmin(ja, jb, exclude_self=exclude_self, interpret=True) \
        if not kw else None
    return np.asarray(ji), np.asarray(jd), (
        None if pi is None else np.asarray(pi))


def _gaps(a, b, exclude_self):
    """float64 (best, second-best) distance per query row."""
    d = ((a.double().numpy()[:, None, :] - b.double().numpy()[None]) ** 2
         ).sum(-1)
    if exclude_self:
        np.fill_diagonal(d, np.inf)
    part = np.partition(d, 1, axis=1)
    return part[:, 0], part[:, 1]


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_nn_chunked_matches_jax(kind, exclude_self):
    """nn_chunked and nn_argmin (its CPU path) against the JAX package's
    nn_chunked and Pallas nn_argmin; Nb = 1280 is not a multiple of 512,
    so the Pallas kernel runs its 256-wide search tiles."""
    na, nb = 700, 1200
    a = _padded(_points(kind, na, 1))
    b = a if exclude_self else _padded(_points(kind, nb, 2))
    if not exclude_self:
        assert b.shape[0] == 1280
    i, d = nn_chunked(a, b, exclude_self)
    ia, da = nn_argmin(a, b, exclude_self)
    assert torch.equal(i, ia) and torch.equal(d, da)
    assert i.dtype == torch.int32 and d.dtype == torch.float32
    assert torch.equal(recompute_dist_sq(a, b, i)[:na], d[:na])
    ji, jd, pi = _jax_nn(a, b, exclude_self)
    i, d = i.numpy()[:na], d.numpy()[:na]
    nv = na if exclude_self else nb
    best, second = _gaps(a[:na], b[:nv], exclude_self)
    if kind == "int":
        np.testing.assert_array_equal(i, ji[:na])
        np.testing.assert_array_equal(d, jd[:na])
        np.testing.assert_array_equal(i, pi[:na])
        np.testing.assert_array_equal(d, best)  # exact in float32
    else:
        assert_float_agree(d, i, jd[:na], ji[:na], best, second)
        assert_float_agree(d, i, jd[:na], pi[:na], best, second)
    if exclude_self:
        assert not np.any(i == np.arange(na))


def test_offsets_mask_the_global_diagonal():
    """A block of query rows at global offset 256 searched against the
    whole cloud excludes its own global rows, as the JAX package's
    nn_chunked does for the ring."""
    a = _padded(_points("int", 1000, 3))
    block = a[256:768]
    i, d = nn_chunked(block, a, exclude_self=True, a_offset=256)
    full_i, full_d = nn_chunked(a, a, exclude_self=True)
    assert torch.equal(i, full_i[256:768]) and torch.equal(d, full_d[256:768])
    ji, jd, _ = _jax_nn(block, a, exclude_self=True, a_offset=256)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(d.numpy(), jd)


def test_ties_go_to_the_lowest_index():
    """600 equidistant search points: the lowest index wins, in the port
    and in the JAX package's Pallas kernel (tests/test_pallas.py:37-42);
    and the lowest among the tied ones when the first rows are farther."""
    a = np.array([[0.0, 0.0, 0.0]])
    b = np.zeros((600, 3))
    b[:, 0] = 7.0
    i, d = nn_argmin(_padded(a), _padded(b))
    assert int(i[0]) == 0 and float(d[0]) == 49.0
    assert int(_jax_nn(_padded(a), _padded(b))[2][0]) == 0
    b[:5, 0] = 9.0
    i, d = nn_argmin(_padded(a), _padded(b))
    assert int(i[0]) == 5 and float(d[0]) == 49.0
    assert int(_jax_nn(_padded(a), _padded(b))[2][0]) == 5


def test_backend_names():
    assert resolve_backend("auto", nn_ops.PRUNE_THRESHOLD - 1) == "brute"
    assert resolve_backend("auto", nn_ops.PRUNE_THRESHOLD) == "pruned"
    for alias in ("brute", "pallas", "jnp"):
        assert resolve_backend(alias, 10**7) == "brute"
    assert resolve_backend("pruned", 10) == "pruned"
    with pytest.raises(ValueError):
        resolve_backend("kdtree", 10)
    with pytest.raises(ValueError):  # no rows to search
        nn_argmin(_padded(_points("int", 10, 4)), torch.zeros((0, 3)))


def _jax_clouds(o, r):
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    return (JCloud.from_numpy(*o, dtype=jnp.float32, thin=False),
            JCloud.from_numpy(*r, dtype=jnp.float32, thin=False))


def _assert_table_close(got, want):
    assert set(got) == set(want)
    for key in want:
        g = np.asarray(got[key], np.float64)
        w = np.asarray(want[key], np.float64)
        if "psnr" in key:
            assert np.max(np.abs(g - w)) <= PSNR_TOL, (key, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=MSE_RTOL, err_msg=key)


@pytest.mark.parametrize("d2_mode", ["pc_error", "reference"])
def test_small_fused_takes_brute_and_matches_jax(d2_mode, monkeypatch):
    """fused_evaluate(backend="auto") below the threshold: no grid, no
    pruned sweep, and the JAX package's table (its brute branch)."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused

    def no_pruned(*args, **kw):
        raise AssertionError("a small pair reached the pruned search")

    monkeypatch.setattr(fused_mod, "nn_pruned_sorted", no_pruned)
    o, r = _pair_arrays(11, n=1500)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode=d2_mode)
    a = Cloud.from_numpy(*o, device="cpu")
    b = Cloud.from_numpy(*r, device="cpu")
    got = fused_evaluate(a, b, **kw)
    assert a._grid is None and b._grid is None
    ja, jb = _jax_clouds(o, r)
    _assert_table_close(got, jfused(ja, jb, **kw))
    # the boundary stats were cached; a second call gives the same table
    again = fused_evaluate(a, b, **kw)
    for key in got:
        np.testing.assert_array_equal(np.asarray(again[key]),
                                      np.asarray(got[key]))


def test_brute_pair_and_boundary_stats_match_jax():
    """The brute branches of pair_stats (raw sums, rgb colours) and
    boundary_stats against the JAX package's on the same padded arrays."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.fused import boundary_stats as jboundary
    from open_pcc_metric_tpu.ops.fused import pair_stats as jpair_stats

    o, r = _pair_arrays(12, n=1200)
    a = Cloud.from_numpy(*o, device="cpu")
    b = Cloud.from_numpy(*r, device="cpu")
    kw = dict(color_scheme="rgb", point_to_plane=True, d2_mode="pc_error",
              with_boundary=True)
    got = pair_stats(a.points, b.points, a.n, b.n, a.colors, b.colors,
                     a.normals, b.normals, backend="brute", **kw)
    assert "nn_overflow" not in got
    ja, jb = _jax_clouds(o, r)
    want = jpair_stats(ja.points, jb.points, jnp.asarray(ja.n),
                       jnp.asarray(jb.n), ja.colors, jb.colors, ja.normals,
                       jb.normals, backend="jnp", **kw)
    assert set(got) == set(want)
    for key in want:
        g = np.asarray(got[key], np.float64)
        w = np.asarray(want[key], np.float64)
        if key in EXACT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=MSE_RTOL, err_msg=key)
    mn, mx = boundary_stats(a, backend="brute")
    jmn, jmx = jboundary(ja, backend="jnp")
    assert (float(mn), float(mx)) == (float(jmn), float(jmx))
    assert (float(mn), float(mx)) == (float(got["self_min"]),
                                      float(got["self_max"]))


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_brute_fused_matches_goldens(name):
    """The brute branch reproduces every frozen float64 golden."""
    entry = GOLDENS[name]
    cfg = entry["config"]
    a, b = _golden_pair(cfg)
    got = fused_evaluate(
        a, b, color_scheme=cfg["color"], point_to_plane=cfg["point_to_plane"],
        d2_mode=cfg["d2_mode"], peak=cfg["peak"], backend="brute")
    assert a._grid is None
    for key, want in entry["metrics"].items():
        want = np.asarray(want, dtype=np.float64)
        ours = np.asarray(got[key], dtype=np.float64)
        tol = PSNR_TOL if "psnr" in key else 1e-5
        rel = np.max(np.abs(ours - want) / np.maximum(np.abs(want), 1e-12))
        assert rel < tol, f"{name}/{key}: ours={ours} golden={want} rel={rel}"


def test_cli_backend_aliases(tmp_path, capsys):
    """--backend pallas and jnp are the brute force: the same CSV as
    --backend brute, and as auto on a small pair."""
    o, r = _pair_arrays(13, n=800)
    op, rp = str(tmp_path / "o.ply"), str(tmp_path / "r.ply")
    write_ply(op, o[0], colors=o[1], normals=o[2])
    write_ply(rp, r[0], colors=r[1], normals=r[2])
    flags = ["--ocloud", op, "--pcloud", rp, "--color", "ycc", "--hausdorff",
             "--point-to-plane", "--csv", "--device", "cpu"]
    outs = []
    for backend in ("brute", "pallas", "jnp", "auto"):
        assert cli_main(flags + ["--backend", backend]) == 0
        outs.append(capsys.readouterr().out)
    assert len(set(outs)) == 1 and len(outs[0].strip().splitlines()) == 33


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
def test_cuda_nn_argmin_matches_plain(kind):
    """K5 on the card, bit-identical to nn_chunked on the same card tensors
    in index and distance: cross both ways and self, with b's rows split
    over several blocks (and not, for the small search)."""
    dev = _cuda_or_skip()
    a = _padded(_points(kind, 9000, 5)).to(dev)
    b = _padded(_points(kind, 700, 6)).to(dev)
    before = nn_argmin.launches
    for q, s, ex in ((a, b, False), (b, a, False), (a, a, True)):
        gi, gd = nn_argmin(q, s, ex)
        wi, wd = nn_chunked(q, s, ex)
        assert torch.equal(gi, wi), (q.shape, s.shape, ex)
        assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))
    assert nn_argmin.launches == before + 3
    with pytest.raises(ValueError):
        nn_argmin(a.double(), b.double())


@pytest.mark.cuda
def test_cuda_small_path_launches_k5():
    """A small fused evaluation and a DAG evaluation on the card launch K5
    and give the CPU tables."""
    from open_pcc_metric_tpu_torch.evaluate import evaluate_pair
    from open_pcc_metric_tpu_torch.options import CalculateOptions

    dev = _cuda_or_skip()
    o, r = _pair_arrays(14, n=3000)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    want = fused_evaluate(Cloud.from_numpy(*o, device="cpu"),
                          Cloud.from_numpy(*r, device="cpu"), **kw)
    a = Cloud.from_numpy(*o, device=dev)
    b = Cloud.from_numpy(*r, device=dev)
    before = nn_argmin.launches
    got = fused_evaluate(a, b, **kw)
    assert nn_argmin.launches > before
    _assert_table_close(got, want)
    opts = CalculateOptions(color="ycc", hausdorff=True, point_to_plane=True,
                            d2_mode="pc_error")
    before = nn_argmin.launches
    dag = evaluate_pair(Cloud.from_numpy(*o, device=dev),
                        Cloud.from_numpy(*r, device=dev), opts,
                        engine="dag").as_dict()
    assert nn_argmin.launches > before
    cpu = evaluate_pair(Cloud.from_numpy(*o, device="cpu"),
                        Cloud.from_numpy(*r, device="cpu"), opts,
                        engine="dag").as_dict()
    for key in cpu:
        g = np.asarray(dag[key], np.float64)
        w = np.asarray(cpu[key], np.float64)
        if "PSNR" in key[0]:
            assert np.max(np.abs(g - w)) <= PSNR_TOL, key
        else:
            np.testing.assert_allclose(g, w, rtol=MSE_RTOL, err_msg=str(key))
