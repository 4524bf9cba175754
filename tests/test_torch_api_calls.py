"""PyTorch port: calls made the JAX package's way, positionally or by
keyword, bind each argument to its JAX meaning and give JAX's result, or
raise.

The TPU layout parameters (chunk sizes, query packs, the interpret switch,
the ring axis) sit in JAX's places and are checked, so that an argument
misbound there raises; the JAX package's ``refine_impl`` names run the
port's schedules; the synthetic pairs take ``device`` by keyword only;
``Cloud.has_colors`` and ``CalculateResult.rows`` stand for JAX's
``has_colors`` and ``as_df``; and the two defaults that stay the port's
(tests/test_torch_api_parity.py's ``KNOWN_DEFAULTS``) give JAX's result.
Clouds stay at or below 4000 points and every JAX function runs as plain
XLA on the CPU: no interpret-mode program is compiled.
"""
import logging

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import (Cloud, synthetic_sphere_pair,
                                             synthetic_voxel_pair)
from open_pcc_metric_tpu_torch.evaluate import evaluate_pair
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import nn_pruned as nnp
from open_pcc_metric_tpu_torch.ops import refine_adaptive as ra
from open_pcc_metric_tpu_torch.ops.knn import knn
from open_pcc_metric_tpu_torch.ops.nn import nn_chunked
from open_pcc_metric_tpu_torch.options import CalculateOptions
from open_pcc_metric_tpu_torch.parallel.sharded import ring_knn_coords, ring_nn
from open_pcc_metric_tpu_torch.utils import logging as port_logging

from test_torch_fixed_sched import _spy
from test_torch_fused import _pair_arrays
from test_torch_refine import jax_on_cpu

REFINE_ENVS = ("PCC_REFINE_IMPL", "PCC_NN_EXPANDED")
JAX_REFINE_NAMES = ("auto", "pallas", "pallas_interpret", "xla", "adaptive",
                    "adaptive_interpret")


def _int_points(n, hi, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, (n, 3)).astype(np.float32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _same_stats(got, want):
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(torch.as_tensor(got[key]),
                           torch.as_tensor(want[key])), key


def test_nn_chunked_jax_positional_call_matches_jax():
    """``nn_chunked(a, a, True, 256, 1024)``, JAX's chunk sizes in JAX's
    places: the same rows as the keyword call and as JAX's, none at its own
    point; a row offset misbound into a chunk size raises."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.nn import nn_chunked as jnn_chunked

    pts = _int_points(2000, 64, 5)
    a = torch.from_numpy(pts)
    got = nn_chunked(a, a, True, 256, 1024)
    _same(got, nn_chunked(a, a, exclude_self=True))
    wi, wd = jnn_chunked(jnp.asarray(pts), jnp.asarray(pts), True, 256, 1024)
    assert int((got[0].numpy() != np.asarray(wi)).sum()) == 0
    assert int((got[1].numpy() != np.asarray(wd)).sum()) == 0
    assert not (got[0].numpy() == np.arange(2000)).any()
    with pytest.raises(ValueError, match="chunk_a"):
        nn_chunked(a, a, True, 0)
    with pytest.raises(TypeError, match="chunk_b"):
        nn_chunked(a, a, True, 256, torch.tensor(1024))


def test_knn_takes_jax_chunk_sizes():
    a = torch.from_numpy(_int_points(600, 32, 6))
    _same(knn(a, a, 8, True, 256, 1024), knn(a, a, 8, exclude_self=True))
    with pytest.raises(ValueError, match="chunk_a"):
        knn(a, a, 8, True, -1)


def _pruned_pair(seed=3):
    o, r = _pair_arrays(seed)
    a, b = (Cloud.from_numpy(*x, pad_to=4096, device="cpu") for x in (o, r))
    return a, b, a.get_grid(), b.get_grid()


def test_pair_stats_jax_positional_call_binds_as_jax():
    """JAX's positional order, ``qt8_a=None, qt8_b=None`` included, gives
    the keyword call's stats bit for bit; the old positional order (the
    colour scheme where ``qt8_a`` is) and a normals array there raise."""
    a, b, ga, gb = _pruned_pair()
    got = fused_mod.pair_stats(
        a.points, b.points, a.n, b.n, a.colors, b.colors, a.normals,
        b.normals, ga, gb, None, None, None, None, None, None, "ycc", True,
        "pc_error", True, "pruned", 32, 256, False)
    want = fused_mod.pair_stats(
        a.points, b.points, a.n, b.n, a_col=a.colors, b_col=b.colors,
        a_nrm=a.normals, b_nrm=b.normals, ga=ga, gb=gb, color_scheme="ycc",
        point_to_plane=True, d2_mode="pc_error", with_boundary=True,
        backend="pruned", prune_cap=32, prune_fallback=256, mxu_ok=False)
    _same_stats(got, want)
    head = (a.points, b.points, a.n, b.n, a.colors, b.colors, a.normals,
            b.normals, ga, gb, None, None, None, None)
    with pytest.raises(ValueError, match="qt8_a"):
        fused_mod.pair_stats(*head, "ycc", True, "pc_error")
    with pytest.raises(ValueError, match="qt8_b"):
        fused_mod.pair_stats(*head, None, b.normals, backend="pruned")


def test_cold_pair_program_jax_positional_call_binds_as_jax():
    a, b, ga, gb = _pruned_pair(4)
    got, _ = fused_mod.cold_pair_program(
        a.points, b.points, a.n, b.n, a.colors, b.colors, ga, gb, None, None,
        a.normals, None, b.normals, None, None, None, None, "ycc", True,
        "pc_error", False, False, 30, 64, 256, 32, 256, False, None)
    want, _ = fused_mod.cold_pair_program(
        a.points, b.points, a.n, b.n, a_col=a.colors, b_col=b.colors, ga=ga,
        gb=gb, a_nrm=a.normals, b_nrm=b.normals, color_scheme="ycc",
        point_to_plane=True, d2_mode="pc_error", est_a=False, est_b=False)
    _same_stats(got, want)
    with pytest.raises(ValueError, match="qt8_a"):
        fused_mod.cold_pair_program(a.points, b.points, a.n, b.n, a.colors,
                                    b.colors, ga, gb, a.normals)


def test_pair_stats_defaults_match_jax():
    """Every default on both sides (JAX's ``backend="jnp"``, the brute
    force here too): the same stats bit for bit on an integer pair."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.ops.fused import pair_stats as jpair_stats

    o, r = _pair_arrays(5, n=1500)
    a, b = (Cloud.from_numpy(x[0], device="cpu") for x in (o, r))
    ja, jb = (JCloud.from_numpy(x[0], dtype=jnp.float32, thin=False)
              for x in (o, r))
    got = fused_mod.pair_stats(a.points, b.points, a.n, b.n)
    want = jpair_stats(ja.points, jb.points, jnp.asarray(ja.n),
                       jnp.asarray(jb.n))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_pair_stats_default_rung_is_jax(monkeypatch):
    """``prune_cap``/``prune_fallback`` default to None, which reads
    PCC_NN_CAP/PCC_NN_FT at the call: with both unset that is JAX's rung
    (32, 256), and the stats equal the call that passes it."""
    for var in ("PCC_NN_CAP", "PCC_NN_FT"):
        monkeypatch.delenv(var, raising=False)
    assert fused_mod.nn_base_rung() == (32, 256)
    a, b, ga, gb = _pruned_pair(6)
    calls = _spy(monkeypatch, fused_mod, "nn_pruned_sorted")
    got = fused_mod.pair_stats(a.points, b.points, a.n, b.n, ga=ga, gb=gb,
                               backend="pruned")
    assert [(c[1]["cap"], c[1]["fallback_tiles"]) for c in calls] == \
        [(32, 256)] * 3
    want = fused_mod.pair_stats(a.points, b.points, a.n, b.n, ga=ga, gb=gb,
                                backend="pruned", prune_cap=32,
                                prune_fallback=256)
    _same_stats(got, want)


def _search_grids(seed=9):
    rng = np.random.default_rng(seed)
    a = Cloud.from_numpy(rng.integers(0, 200, (4000, 3)).astype(float),
                         device="cpu")
    b = Cloud.from_numpy(rng.integers(0, 200, (3300, 3)).astype(float),
                         device="cpu")
    return a, b, a.get_grid(build="device"), b.get_grid(build="device")


@pytest.mark.parametrize("name", JAX_REFINE_NAMES)
def test_refine_impl_jax_names_equal_default(name, monkeypatch):
    """Each of the JAX package's names runs the default schedule through
    K1's wrapper (on clouds not asserted ``mxu_exact``, the adaptive names
    too, as in JAX) and gives its rows bit for bit."""
    for var in REFINE_ENVS:
        monkeypatch.delenv(var, raising=False)
    a, _, ga, gb = _search_grids()
    want = nnp.nn_pruned_sorted(ga, gb, a.n, refine_impl="default")
    calls = _spy(monkeypatch, nnp, "refine_nn")
    got = nnp.nn_pruned_sorted(ga, gb, a.n, refine_impl=name)
    assert calls
    _same(got, want)


def test_refine_impl_auto_reads_env_and_adaptive_interpret_is_adaptive(
        monkeypatch):
    """``"auto"``, the default, reads PCC_REFINE_IMPL at the call as None
    does; JAX's ``"adaptive_interpret"`` is the adaptive schedule (K7's
    wrapper), bit for bit; an unknown name raises."""
    for var in REFINE_ENVS:
        monkeypatch.delenv(var, raising=False)
    assert nnp.resolve_refine_impl("auto") == "default"
    monkeypatch.setenv("PCC_NN_EXPANDED", "1")
    assert nnp.resolve_refine_impl("auto") == "expanded"
    assert nnp.resolve_refine_impl("xla") == "default"
    monkeypatch.delenv("PCC_NN_EXPANDED")
    a, _, ga, gb = _search_grids(10)
    want = nnp.nn_pruned_sorted(ga, gb, a.n, refine_impl="adaptive",
                                mxu_ok=True)
    calls = _spy(monkeypatch, nnp, "adaptive_refine")
    _same(nnp.nn_pruned_sorted(ga, gb, a.n, refine_impl="adaptive_interpret",
                               mxu_ok=True), want)
    assert calls
    del calls[:]
    monkeypatch.setenv("PCC_REFINE_IMPL", "adaptive")
    _same(nnp.nn_pruned_sorted(ga, gb, a.n, mxu_ok=True), want)
    assert calls
    with pytest.raises(ValueError, match="refine_impl"):
        nnp.nn_pruned_sorted(ga, gb, a.n, refine_impl="bogus")


def test_layout_parameters_of_the_sorted_searches_are_checked():
    """``qt8`` (nn_pruned_sorted, nn_pruned_bucketed_sorted) and
    ``interpret`` (nn_pruned_bucketed_sorted, nn_pruned_adaptive_sorted)
    take JAX's values and refuse a misbound argument."""
    a, _, ga, gb = _search_grids(11)
    want = nnp.nn_pruned_sorted(ga, gb, a.n)
    pack = torch.zeros((8, ga.points.shape[0]))
    _same(nnp.nn_pruned_sorted(ga, gb, a.n, False, 32, 128, "auto", False,
                               pack), want)
    with pytest.raises(ValueError, match="qt8"):
        nnp.nn_pruned_sorted(ga, gb, a.n, qt8=ga.points)
    bucketed = nnp.nn_pruned_bucketed_sorted(ga, gb, a.n, 8, 40)
    _same(nnp.nn_pruned_bucketed_sorted(ga, gb, a.n, 8, 40, False, False,
                                        None), bucketed)
    with pytest.raises(TypeError, match="interpret"):
        nnp.nn_pruned_bucketed_sorted(ga, gb, a.n, 8, 40, 1)
    with pytest.raises(TypeError, match="interpret"):
        nnp.nn_pruned_adaptive_sorted(ga, gb, a.n, False, 64, 64, 8, None)


def test_adaptive_refine_binds_interpret_not_splits():
    """``adaptive_refine(..., exclude_self, True)`` binds JAX's
    ``interpret``; ``splits`` is keyword-only, so the old positional slot
    count raises."""
    a, _, ga, gb = _search_grids(12)
    _, _, order = nnp.tile_bounds(ga, gb, a.n)
    nta = order.shape[0]
    args = (ra.pack_queries(ga.points),
            ra.pack_candidates(gb.points, gb.perm), order[:, :6].contiguous(),
            torch.full((nta,), 6, dtype=torch.int32),
            torch.arange(nta, dtype=torch.int32))
    _same(ra.adaptive_refine(*args, None, False, True),
          ra.adaptive_refine(*args, exclude_self=False))
    with pytest.raises(TypeError, match="interpret"):
        ra.adaptive_refine(*args, None, False, 2)


def test_payload_jax_layout_raises():
    """The sorted payload is (Pb, PAYLOAD_F) rows; JAX's transposed
    ``payT_sorted`` layout, any other width, and JAX's keyword raise."""
    a, b, ga, gb = _search_grids(13)
    pay_s = fused_mod._pack_payload(gb.points, None, None)
    pay_o = fused_mod._pack_payload(b.points, None, None)
    d, i, _, _ = nnp.nn_pruned_sorted_payload(ga, gb, pay_s, pay_o, a.n)
    _same((d, i), nnp.nn_pruned_sorted(ga, gb, a.n)[:2])
    for bad in (pay_s.t().contiguous(), pay_s[:, :9]):
        with pytest.raises(ValueError, match="pay_sorted"):
            nnp.nn_pruned_sorted_payload(ga, gb, bad, pay_o, a.n)
    with pytest.raises(TypeError, match="payT_sorted"):
        nnp.nn_pruned_sorted_payload(ga, gb, payT_sorted=pay_s.t(),
                                     pay_orig=pay_o, n_a=a.n)


def test_ring_functions_take_axis_in_jax_place():
    """``axis`` sits where JAX has it: a JAX-style positional call equals
    the keyword call, and the port's old positional payloads (a tuple where
    ``axis`` is) raise."""
    pts = torch.from_numpy(_int_points(1024, 40, 14))
    slots = [pts[:512], pts[512:]]
    pay = [(s * 2.0) for s in slots]
    got = ring_nn(slots, slots, "points", (pay,), True)
    want = ring_nn(slots, slots, payloads=(pay,), exclude_self=True)
    for g, w in zip(got[:2], want[:2]):
        _same(g, w)
    _same(got[2][0], want[2][0])
    with pytest.raises(TypeError, match="axis"):
        ring_nn(slots, slots, (pay,))
    got = ring_knn_coords(slots, slots, 6, None)
    want = ring_knn_coords(slots, slots, k=6)
    for g, w in zip(got, want):
        _same(g, w)
    with pytest.raises(TypeError, match="axis"):
        ring_knn_coords(slots, slots, 6, 16)


@pytest.mark.parametrize("fn,spread", [("synthetic_voxel_pair", 512),
                                       ("synthetic_sphere_pair", 0.01)])
def test_synthetic_pair_jax_positional_dtype(fn, spread):
    """``(n, grid|noise, seed, with_colors, dtype)`` binds JAX's dtype and
    draws JAX's points and colours; a positional device raises."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu import cloud as jcloud

    port_fn = {"synthetic_voxel_pair": synthetic_voxel_pair,
               "synthetic_sphere_pair": synthetic_sphere_pair}[fn]
    got = port_fn(500, spread, 0, True, torch.float64, device="cpu")
    want = getattr(jcloud, fn)(500, spread, 0, True, jnp.float64)
    for g, w in zip(got, want):
        assert g.points.dtype == torch.float64 and g.n == w.n
        np.testing.assert_array_equal(g.points.numpy(), np.asarray(w.points))
        np.testing.assert_array_equal(g.colors.numpy(), np.asarray(w.colors))
    with pytest.raises(TypeError):
        port_fn(500, spread, 0, True, "cpu")


def test_has_colors_matches_jax():
    jax_on_cpu()
    from open_pcc_metric_tpu.cloud import Cloud as JCloud

    pts = _int_points(300, 50, 15).astype(np.float64)
    col = np.random.default_rng(15).uniform(0, 1, pts.shape)
    for colors in (col, None):
        got = Cloud.from_numpy(pts, colors, device="cpu").has_colors()
        assert got == JCloud.from_numpy(pts, colors).has_colors()
        assert got == (colors is not None)


def test_rows_equal_jax_as_df():
    """``rows()`` is JAX's ``as_df()`` frame row for row (label, is_left,
    point-to-plane, value as the table prints them) on an integer pair,
    whose every value both packages compute exactly."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu import CalculateOptions as JOptions
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.evaluate import evaluate_pair as jevaluate

    o, r = _pair_arrays(7, n=1500)
    opts = dict(hausdorff=True)
    got = evaluate_pair(*(Cloud.from_numpy(x[0], device="cpu")
                          for x in (o, r)), CalculateOptions(**opts))
    want = jevaluate(*(JCloud.from_numpy(x[0], dtype=jnp.float32, thin=False)
                       for x in (o, r)), JOptions(**opts))
    assert got.rows() == [tuple(str(v) for v in row)
                          for row in want.as_df().values.tolist()]


def test_logger_default_name_configures_alike():
    """The port's logger keeps its own default name; under JAX's default
    name it is configured as under its own, and as JAX's is."""
    from open_pcc_metric_tpu.utils.logging import get_logger as jget_logger

    mine = port_logging.get_logger()
    theirs = port_logging.get_logger("pcc_metric_tpu")
    ref = jget_logger()
    assert mine.name == "pcc_metric_tpu_torch" and theirs is ref
    for lg in (mine, theirs):
        assert lg.level == logging.INFO and not lg.propagate
        assert len(lg.handlers) == 1
        assert lg.handlers[0].formatter._fmt == \
            ref.handlers[0].formatter._fmt
