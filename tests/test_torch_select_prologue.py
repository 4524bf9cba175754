"""PyTorch port: the pruned searches under the select prologue (K2a + K2b)
against the JAX package's select mode, and the entry points that reach it.

The JAX side runs ``nn_pruned_sorted`` / ``knn_pruned_sorted`` with
``refine_impl="pallas_interpret"`` and ``PCC_NN_PROLOGUE`` /
``PCC_KNN_PROLOGUE`` set to "select", the only way it takes the select
prologue on the CPU. JAX reads ``PCC_NN_PROLOGUE`` when it traces, so its
cache is cleared before and after each such call, and a spy proves that its
select kernels ran. Both packages get the same grid. d, id and ``overflow``
must agree (bit for bit on integer clouds, by the float rule of
test_torch_refine.py on float ones), the port's select mode must equal its
default prologue bit for bit, and the k-NN moments agree within rtol 2e-5 /
atol 2e-3 (the tier tiles' sums are taken again from zero, over the same
members in another order).
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import knn_pruned as knn_mod
from open_pcc_metric_tpu_torch.ops import normals as nops
from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_mod
from open_pcc_metric_tpu_torch.ops import select as S
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned_sorted
from open_pcc_metric_tpu_torch.ops.nn_pruned import nn_pruned_sorted

from test_torch_fused import _assert_stats_close, _pair_arrays
from test_torch_knn_pruned import jax_knn_sorted
from test_torch_nn_pruned import _check, _grid, _jax_nn, _points
from test_torch_refine import jax_on_cpu

K = 30
D2_TOL = 5e-3  # dB, D2 with estimated normals (float32 eigenvectors)


def _spy_jax_select(monkeypatch):
    """Count the JAX package's select-kernel calls."""
    from open_pcc_metric_tpu.ops import select_pallas

    calls = {"select": 0, "count": 0}
    for key, name in (("select", "select_bbox_pallas"),
                      ("count", "count_bbox_pallas")):
        real = getattr(select_pallas, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(select_pallas, name, spy)
    return calls


def _spy_port_select(monkeypatch):
    """Count the port's K2a/K2b wrapper calls from the searches."""
    calls = {"select": 0, "count": 0}
    for key, name in (("select", "select_bbox"), ("count", "count_bbox")):
        real = getattr(nn_mod, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(nn_mod, name, spy)
    return calls


def _jax_nn_select(monkeypatch, ga, gb, n_a, **kw):
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted as jnn

    calls = _spy_jax_select(monkeypatch)
    monkeypatch.setenv("PCC_NN_SCHED", "counted")
    monkeypatch.setenv("PCC_NN_PROLOGUE", "select")
    jnn.clear_cache()
    try:
        out = _jax_nn(ga, gb, n_a, **kw)
    finally:
        # a select-mode executable must not answer a later default call
        jnn.clear_cache()
        monkeypatch.delenv("PCC_NN_PROLOGUE")
    assert calls["select"] >= 1 and calls["count"] >= 2
    return out


@pytest.mark.parametrize("kind,exclude_self", [
    ("int", False), ("float", False), ("int", True),
])
def test_nn_select_matches_jax_select(kind, exclude_self, monkeypatch):
    """~3000-point clouds, cap 24, 48 fallback tiles (test_select.py's)."""
    a, ga = _grid(_points(kind, 3100, 51 + exclude_self, hi=64), pad_to=4096)
    b, gb = (a, ga) if exclude_self else _grid(
        _points(kind, 2900, 52, hi=64), pad_to=4096)
    kw = dict(exclude_self=exclude_self, cap=24, fallback_tiles=48)
    calls = _spy_port_select(monkeypatch)
    got = nn_pruned_sorted(ga, gb, a.n, prologue="select", **kw)
    assert calls["select"] == 1 and calls["count"] == 2
    want = _jax_nn_select(monkeypatch, ga, gb, a.n, **kw)
    _check(kind, got, want, ga, gb, a.n, b.n, exclude_self)
    default = nn_pruned_sorted(ga, gb, a.n, **kw)
    assert calls["select"] == 1  # the default prologue runs no K2a
    for x, y in zip(got, default):
        assert torch.equal(x[: a.n] if x.ndim else x, y[: a.n] if y.ndim else y)


def test_nn_select_tiers_a_and_b_match_jax(monkeypatch):
    """One query tile over a 136-chunk cloud qualifies every chunk: stage 1
    (cap 12) and tier A (128) overflow, and tier B (136), which refines
    its full true-lb prefix from a seed, certifies."""
    a, ga = _grid(_points("int", 100, 23))
    b, gb = _grid(_points("int", 34000, 24), pad_to=136 * CHUNK)
    assert bool(nn_pruned_sorted(ga, gb, a.n, cap=12, fallback_tiles=0,
                                 prologue="select")[2])
    launches = []
    real = nn_mod.refine_nn

    def spy(*args, **kw):
        launches.append(args[3].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(nn_mod, "refine_nn", spy)
    kw = dict(cap=12, fallback_tiles=128)
    got = nn_pruned_sorted(ga, gb, a.n, prologue="select", **kw)
    # probe, extension, tier A and tier B over their full prefixes
    assert launches == [8, 4, 128, 136]
    want = _jax_nn_select(monkeypatch, ga, gb, a.n, **kw)
    _check("int", got, want, ga, gb, a.n, b.n, False)


def _knn_grid(seed):
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, 48, (3900, 3)), axis=0).astype(float)
    return _grid(pts, pad_to=16 * CHUNK)


@pytest.mark.parametrize("cap,ft", [(16, 32), (12, 64)])
def test_knn_select_with_moments_matches_jax_select(cap, ft, monkeypatch):
    """Self 30-NN with moments on 16 tiles: cap 16 selects every chunk
    (cap == ncb), cap 12 runs tier A and sums the moments of its uncovered
    tiles again from zero. No K3 call visits a chunk a tile has already
    refined (the CUDA K3 merge would keep a second copy of its points)."""
    a, ga = _knn_grid(61 + cap)
    kw = dict(cap=cap, fallback_tiles=ft, with_moments=True)
    calls = _spy_port_select(monkeypatch)
    scratch = []
    visited = {}
    real_mom, real_knn = knn_mod.knn_moments, knn_mod.refine_knn

    def spy_mom(*args, **kw_):
        if kw_.get("tiles") is not None:
            scratch.append((kw_.get("init") is None, int(args[4].sum())))
        return real_mom(*args, **kw_)

    def spy_knn(*args, **kw_):
        cand, tiles, ncand = args[3], kw_.get("tiles"), kw_.get("ncand")
        for row in range(cand.shape[0]):
            tile = row if tiles is None else int(tiles[row])
            live = cand.shape[1] if ncand is None else int(ncand[row])
            chunks = cand[row, :live].tolist()
            seen = visited.setdefault(tile, set())
            assert not seen & set(chunks), (tile, seen & set(chunks))
            seen.update(chunks)
        return real_knn(*args, **kw_)

    monkeypatch.setattr(knn_mod, "knn_moments", spy_mom)
    monkeypatch.setattr(knn_mod, "refine_knn", spy_knn)
    got = knn_pruned_sorted(ga, ga, a.n, K, prologue="select", **kw)
    assert calls["select"] == 1 and calls["count"] == 3
    if cap == 12:  # the tier's moments were summed from zero, non-empty
        assert scratch and all(z for z, _ in scratch)
        assert sum(n for _, n in scratch) > 0
        assert max(len(v) for v in visited.values()) > cap  # tier A ran
    jcalls = _spy_jax_select(monkeypatch)
    monkeypatch.setenv("PCC_KNN_PROLOGUE", "select")
    want = jax_knn_sorted(ga, ga, a.n, **kw)
    monkeypatch.delenv("PCC_KNN_PROLOGUE")
    assert jcalls["select"] >= 1 and jcalls["count"] >= 3
    n = a.n
    assert bool(got[2]) == bool(want[2]) and not want[2]
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(x.numpy()[:n], y[:n])
    mom = got[3].numpy()[:n]
    np.testing.assert_array_equal(mom[:, 0], want[3][:n, 0])
    assert np.all(mom[:, 0] == K)
    np.testing.assert_allclose(mom, want[3][:n], rtol=2e-5, atol=2e-3)
    visited.clear()  # the default prologue visits no chunk twice either
    default = knn_pruned_sorted(ga, ga, a.n, K, **kw)
    for x, y in zip(got[:3], default[:3]):
        assert torch.equal(x[:n] if x.ndim else x, y[:n] if y.ndim else y)
    torch.testing.assert_close(got[3][:n], default[3][:n], rtol=2e-5,
                               atol=2e-3)


def test_fused_evaluate_under_select_matches_jax(monkeypatch):
    """fused_evaluate with PCC_NN_PROLOGUE=select and PCC_KNN_PROLOGUE=select
    on a small pair (16 tiles each), pinned to the pruned search, against
    the JAX package's default prologue (JAX takes select only in interpret
    mode): with the files' normals every value within the fused tests'
    bars; without normals (estimated through the select k-NN) the D2 PSNRs
    within 5e-3 dB and the rest within 1e-4. Then, in the same process,
    the env vars unset: the next call runs no K2a or K2b."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.ops import normals as jnops
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused

    monkeypatch.setattr(nops, "_PRUNE_THRESHOLD", 1024)
    monkeypatch.setattr(jnops, "_PRUNE_THRESHOLD", 1024)
    o, r = _pair_arrays(1)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error",
              backend="pruned")

    def jcloud(arrays, normals):
        return JCloud.from_numpy(arrays[0], colors=arrays[1],
                                 normals=arrays[2] if normals else None,
                                 dtype=jnp.float32, pad_to=4096, thin=False)

    def cloud(arrays, normals):
        return Cloud.from_numpy(arrays[0], colors=arrays[1],
                                normals=arrays[2] if normals else None,
                                pad_to=4096, device="cpu")

    calls = _spy_port_select(monkeypatch)
    for normals in (True, False):
        want = jfused(jcloud(o, normals), jcloud(r, normals), **kw)
        monkeypatch.setenv("PCC_NN_PROLOGUE", "select")
        monkeypatch.setenv("PCC_KNN_PROLOGUE", "select")
        before = dict(calls)
        got = fused_mod.fused_evaluate(cloud(o, normals), cloud(r, normals),
                                       **kw)
        # three sweeps with normals (two, and two estimations, without)
        assert calls["select"] - before["select"] >= 3 + (not normals)
        if normals:
            _assert_stats_close(got, want)
        else:
            d2 = [k for k in want if k.startswith("d2_") and "psnr" in k]
            rest = [k for k in want if "psnr" in k and k not in d2]
            _assert_stats_close(got, want, rest)
            for key in d2:
                assert abs(float(got[key]) - float(want[key])) <= D2_TOL, key
        monkeypatch.delenv("PCC_NN_PROLOGUE")
        monkeypatch.delenv("PCC_KNN_PROLOGUE")
        before = dict(calls)
        again = fused_mod.fused_evaluate(cloud(o, normals), cloud(r, normals),
                                         **kw)
        assert calls == before  # the default prologue, read at the call
        for key in got:
            np.testing.assert_array_equal(np.asarray(again[key]),
                                          np.asarray(got[key]))


def test_resolve_prologue_reads_the_env_at_each_call(monkeypatch):
    monkeypatch.delenv("PCC_NN_PROLOGUE", raising=False)
    assert nn_mod.resolve_prologue(None, "PCC_NN_PROLOGUE") == "xla"
    for value, want in (("select", "select"), ("xla", "xla"),
                        ("bogus", "xla"), ("SELECT", "xla")):
        monkeypatch.setenv("PCC_NN_PROLOGUE", value)
        assert nn_mod.resolve_prologue(None, "PCC_NN_PROLOGUE") == want
    assert nn_mod.resolve_prologue("xla", "PCC_NN_PROLOGUE") == "xla"
    with pytest.raises(ValueError):
        nn_mod.resolve_prologue("bogus", "PCC_NN_PROLOGUE")
    # float64 clouds and cap <= 8 keep the default prologue, as in JAX
    assert not nn_mod.uses_select("select", 32, torch.float64)
    assert not nn_mod.uses_select("select", 8, torch.float32)
    assert nn_mod.uses_select("select", 9, torch.float32)


@pytest.mark.cuda
def test_cuda_select_path_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2a and K2b have no CPU mode")
    dev = torch.device("cuda")

    def to(g):
        return type(g)(*(x.to(dev) for x in g))

    a, ga = _grid(_points("float", 3500, 71, hi=64), pad_to=4096)
    _, gb = _grid(_points("float", 3000, 72, hi=64), pad_to=4096)
    before = (S.select_bbox.launches, S.count_bbox.launches)
    for q, s, ex in ((ga, gb, False), (ga, ga, True)):
        kw = dict(exclude_self=ex, cap=12, fallback_tiles=4,
                  prologue="select")
        want = nn_pruned_sorted(q, s, a.n, **kw)
        got = nn_pruned_sorted(to(q), to(s), a.n, **kw)
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)
    kg, g = _knn_grid(73)
    kw = dict(cap=12, fallback_tiles=64, with_moments=True, prologue="select")
    want = knn_pruned_sorted(g, g, kg.n, K, **kw)
    got = knn_pruned_sorted(to(g), to(g), kg.n, K, **kw)
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(x.cpu(), y)
    torch.testing.assert_close(got[3].cpu(), want[3], rtol=1e-6, atol=1e-4)
    # one K2a per search; two K2b per 1-NN sweep, three per k-NN
    assert S.select_bbox.launches == before[0] + 3
    assert S.count_bbox.launches == before[1] + 7
