"""PyTorch port: the payload refine (K6) and the payload schedule against the
JAX package.

The JAX side runs ``refine_nn_pallas_payload(..., interpret=True)`` and
``nn_pruned_sorted_payload``, whose kernel is imported when the jitted
function traces: the test patches it with an interpret-mode partial and
clears the function's cache before and after. On integer clouds d and id
must agree bit for bit on valid rows; the port's payload must equal a
gather of the original-order payload at the returned id bit for bit, and
JAX's within rtol 1e-6 (its one-hot selection is a HIGHEST-precision
matrix product, tests/test_pallas.py). Tables under
``PCC_PAYLOAD_KERNEL=1`` equal the default's bit for bit and JAX's within
the fused tests' bars.
"""
import functools

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import fused as fused_mod
from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_mod
from open_pcc_metric_tpu_torch.ops import refine as refine_mod
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.nn_pruned import (
    nn_pruned_sorted, nn_pruned_sorted_payload, tile_bounds)
from open_pcc_metric_tpu_torch.ops.refine import (
    PAYLOAD_F, refine_nn_payload, refine_nn_payload_reference,
    refine_nn_reference)

from test_torch_adaptive import KW, _fused_pair, _jgrid, _spy
from test_torch_fused import _assert_stats_close, _pair_arrays
from test_torch_refine import jax_on_cpu


def _payload_cloud(n, seed, pad_to=None, hi=512):
    """An integer cloud with colours and unit normals, its grid, and its
    (sorted, original-order) payload rows [pts, col, nrm, 0 x 7]."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, hi, (n, 3)).astype(np.float64)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    c = Cloud.from_numpy(pts, colors=rng.uniform(0, 1, (n, 3)), normals=nrm,
                         pad_to=pad_to, device="cpu")
    g = c.get_grid(build="device")
    orig = fused_mod._pack_payload(c.points, c.colors, c.normals)
    return c, g, orig[g.perm.long()], orig


@pytest.mark.parametrize("exclude_self", [False, True])
def test_payload_reference_matches_jax(exclude_self):
    """tests/test_pallas.py::test_payload_kernel_interpret_matches_gathers:
    a self search over the 8 lowest-bound chunks of 8 tiles."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.refine_pallas import refine_nn_pallas_payload

    c, g, pay_s, pay_o = _payload_cloud(2000, 50)
    _, _, order = tile_bounds(g, g, c.n)
    cand = order[:, :8].contiguous()
    d, i, pay = refine_nn_payload_reference(g.points, g.points, g.perm, pay_s,
                                            cand, exclude_self=exclude_self)
    qt8 = jnp.pad(jnp.asarray(g.points.numpy()), ((0, 0), (0, 5))).T
    jd, ji, jpay = refine_nn_pallas_payload(
        qt8, qt8, jnp.asarray(g.perm.numpy())[None, :],
        jnp.asarray(pay_s.numpy()).T, jnp.asarray(cand.numpy()),
        exclude_self=exclude_self, interpret=True)
    n = c.n
    np.testing.assert_array_equal(d.reshape(-1)[:n].numpy(), np.asarray(jd)[:n])
    np.testing.assert_array_equal(i.reshape(-1)[:n].numpy(), np.asarray(ji)[:n])
    idx = i.reshape(-1).long()
    assert torch.equal(pay, pay_o[idx])  # a gather at the id, bit for bit
    np.testing.assert_allclose(pay.numpy(), np.asarray(jpay), rtol=1e-6)
    want_d, want_i = refine_nn_reference(g.points, g.points, g.perm, cand,
                                         exclude_self=exclude_self)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    if exclude_self:
        assert not torch.any(i.reshape(-1)[:n] == g.perm[:n])
    before = refine_nn_payload.launches
    again = refine_nn_payload(g.points, g.points, g.perm, pay_s, cand,
                              exclude_self=exclude_self)
    assert refine_nn_payload.launches == before  # CPU: the plain version
    assert all(torch.equal(x, y) for x, y in zip(again, (d, i, pay)))


def test_payload_reference_validation():
    c, g, pay_s, _ = _payload_cloud(500, 51)
    cand = tile_bounds(g, g, c.n)[2][:, :1].contiguous()
    with pytest.raises(ValueError):
        refine_nn_payload(g.points, g.points, g.perm, pay_s[:, :9], cand)
    with pytest.raises(ValueError):
        refine_nn_payload(g.points, g.points, g.perm, pay_s.double(), cand)
    # an empty candidate row wins nothing: payload zeros, as JAX seeds it
    d, i, pay = refine_nn_payload_reference(
        g.points, g.points, g.perm, pay_s, cand[:, :0])
    assert torch.all(torch.isinf(d)) and torch.all(pay == 0)
    assert torch.all(i == refine_mod.INT_MAX)


def _jax_payload_sorted(monkeypatch, ga, gb, pay_s, pay_o, n_a, **kw):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops import refine_pallas
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted_payload as jp

    calls = _spy(monkeypatch, refine_pallas, "refine_nn_pallas_payload")
    real = refine_pallas.refine_nn_pallas_payload
    monkeypatch.setattr(refine_pallas, "refine_nn_pallas_payload",
                        functools.partial(real, interpret=True))
    ja = _jgrid(ga)
    jb = ja if gb is ga else _jgrid(gb)
    jp.clear_cache()
    try:
        out = jp(ja, jb, jnp.asarray(pay_s.numpy()).T,
                 jnp.asarray(pay_o.numpy()), jnp.asarray(n_a), **kw)
    finally:
        jp.clear_cache()  # no interpret-mode executable outlives the test
    assert len(calls) == 1
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("exclude_self,cap,ft", [
    (False, 12, 128), (True, 12, 128), (False, 2, 3)])
def test_nn_pruned_sorted_payload_matches_jax(exclude_self, cap, ft,
                                              monkeypatch):
    """Stage 1 (K6), the certificate and the from-scratch tier; the last
    case's budget is too small, so overflow is reported by both."""
    a, ga, pay_s, pay_o = _payload_cloud(3500, 52, pad_to=4096)
    if not exclude_self:
        _, gb, pay_s, pay_o = _payload_cloud(3000, 53, pad_to=4096)
    else:
        gb = ga
    kw = dict(exclude_self=exclude_self, cap=cap, fallback_tiles=ft)
    calls = _spy(monkeypatch, nn_mod, "refine_nn")
    got = nn_pruned_sorted_payload(ga, gb, pay_s, pay_o, a.n, **kw)
    # one tier of min(fallback_tiles, nta) tiles over cap2 = 16 chunks
    assert len(calls) == 1
    assert calls[0][0][3].shape == (min(ft, 16), 16)
    want = _jax_payload_sorted(monkeypatch, ga, gb, pay_s, pay_o, a.n, **kw)
    n = a.n
    assert bool(got[3]) == bool(want[3]) == (cap == 2)
    np.testing.assert_array_equal(got[0][:n].numpy(), want[0][:n])
    np.testing.assert_array_equal(got[1][:n].numpy(), want[1][:n])
    assert torch.equal(got[2][:n], pay_o[got[1][:n].long()])
    np.testing.assert_allclose(got[2][:n].numpy(), want[2][:n], rtol=1e-6)
    if cap == 12:  # certified: the default schedule's rows
        default = nn_pruned_sorted(ga, gb, a.n, **kw)
        assert torch.equal(got[0][:n], default[0][:n])
        assert torch.equal(got[1][:n], default[1][:n])


@pytest.mark.parametrize("d2_mode", ["pc_error", "reference"])
def test_fused_evaluate_payload_matches_default_and_jax(d2_mode, monkeypatch):
    """fused_evaluate under PCC_PAYLOAD_KERNEL=1: the two cross sweeps take
    K6 (the self sweep K1), and the table equals the default's bit for
    bit and JAX's within 1e-4 dB (1e-5 relative)."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.ops.fused import fused_evaluate as jfused

    o, r = _pair_arrays(3)
    kw = dict(KW, d2_mode=d2_mode)
    monkeypatch.delenv("PCC_PAYLOAD_KERNEL", raising=False)
    want = jfused(JCloud.from_numpy(*o, dtype=jnp.float32, thin=False),
                  JCloud.from_numpy(*r, dtype=jnp.float32, thin=False), **kw)
    default = fused_mod.fused_evaluate(*_fused_pair(o, r), **kw)
    calls = _spy(monkeypatch, nn_mod, "refine_nn_payload")
    monkeypatch.setenv("PCC_PAYLOAD_KERNEL", "1")
    a, b = _fused_pair(o, r)
    got = fused_mod.fused_evaluate(a, b, **kw)
    assert len(calls) == 2
    assert a._sorted_normals is not None and b._sorted_normals is not None
    for key in default:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(default[key]))
    _assert_stats_close(got, want)
    # without colours or normals there is no payload to carry: K6 stays off
    fused_mod.fused_evaluate(*_fused_pair(o, r), backend="pruned")
    assert len(calls) == 2


def test_both_knobs_take_k6_across_and_k7_for_self(monkeypatch):
    """PCC_PAYLOAD_KERNEL=1 and PCC_REFINE_IMPL=adaptive on an integer pair:
    the cross sweeps run K6, the self sweep K7, as in the JAX package; the
    table is the default's."""
    o, r = _pair_arrays(4)
    default = fused_mod.fused_evaluate(*_fused_pair(o, r, normals=False),
                                       **KW)
    pay_calls = _spy(monkeypatch, nn_mod, "refine_nn_payload")
    ad_calls = _spy(monkeypatch, nn_mod, "adaptive_refine")
    k1_calls = _spy(monkeypatch, nn_mod, "refine_nn")
    monkeypatch.setenv("PCC_PAYLOAD_KERNEL", "1")
    monkeypatch.setenv("PCC_REFINE_IMPL", "adaptive")
    a, b = _fused_pair(o, r, normals=False)  # normals are estimated
    got = fused_mod.fused_evaluate(a, b, **KW)
    assert len(pay_calls) == 2
    assert len(k1_calls) == 0  # cap covers every chunk: no tier
    assert len(ad_calls) == 2  # the self sweep: P1 and P2
    for key in default:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(default[key]))
    a, b = _fused_pair(o, r)  # the files' normals
    got = fused_mod.fused_evaluate(a, b, **KW)
    assert len(pay_calls) == 4 and len(ad_calls) == 4
    assert float(got["max_sqrt"]) == float(default["max_sqrt"])


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_self", [False, True])
def test_cuda_payload_kernel_matches_plain_version(exclude_self):
    """K6 on the card against its plain version (d, id and payload bit for
    bit), and the payload schedule on the card against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    dev = torch.device("cuda")
    a, ga, pay_s, pay_o = _payload_cloud(3500, 54, pad_to=4096)
    gb = ga
    if not exclude_self:
        _, gb, pay_s, pay_o = _payload_cloud(3000, 55, pad_to=4096)

    def to(g):
        return type(g)(*(x.to(dev) for x in g))

    gad = to(ga)
    gbd = gad if exclude_self else to(gb)
    _, _, order = tile_bounds(gad, gbd, a.n)
    args = (gad.points, gbd.points, gbd.perm, pay_s.to(dev),
            order[:, :6].contiguous())
    before = refine_nn_payload.launches
    got = refine_nn_payload(*args, exclude_self=exclude_self)
    torch.cuda.synchronize()
    assert refine_nn_payload.launches == before + 1
    want = refine_nn_payload_reference(*args, exclude_self=exclude_self)
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    kw = dict(exclude_self=exclude_self, cap=12, fallback_tiles=8)
    cpu = nn_pruned_sorted_payload(ga, gb, pay_s, pay_o, a.n, **kw)
    card = nn_pruned_sorted_payload(gad, gbd, pay_s.to(dev), pay_o.to(dev),
                                    a.n, **kw)
    for x, y in zip(card, cpu):
        assert torch.equal(x.cpu(), y)
