"""PyTorch port: the select prologue's kernels, K2a (``select_bbox``) and K2b
(``count_bbox``), against the JAX package's Pallas kernels.

The JAX side is ``select_bbox_pallas`` / ``count_bbox_pallas`` in interpret
mode on the CPU (as tests/test_select.py runs them); the port's side on the
CPU is the plain PyTorch version each wrapper runs there. Both get the same
numpy boxes. On integer boxes every bound is an exact float32 integer, so
``cand``, ``lb_sel`` and the counts must agree bit for bit. On float boxes
XLA may round a bound another way by an ulp, so the port is held to its own
rounded space: ascending, unique, within one rounding bucket of the JAX
space. Counts must never fall below the true-lb or the select-space
qualifying count.

The CUDA kernels are checked against the plain versions, bit for bit, by
the tests marked ``cuda`` (skipped without a card) and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.ops import select as S
from open_pcc_metric_tpu_torch.ops.grid import bbox_lower_bounds

from test_torch_refine import jax_on_cpu

FLT_MAX = float(np.finfo(np.float32).max)


def _int_boxes(rng, n, scale=1024):
    lo = rng.integers(0, scale, (n, 3)).astype(np.float32)
    hi = lo + rng.integers(0, scale // 20 + 1, (n, 3)).astype(np.float32)
    return lo, hi


def _float_boxes(rng, n, scale=100.0):
    lo = rng.uniform(0, scale, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, scale / 20, (n, 3)).astype(np.float32)
    return lo, hi


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _lbs(a_lo, a_hi, b_lo, b_hi):
    """(true lb, rounded lb, ncb_pad) of the port, as numpy."""
    lb = bbox_lower_bounds(*_t(a_lo, a_hi, b_lo, b_hi))
    ncbp = S.pad128(b_lo.shape[0])
    return lb.numpy(), S.mask_lb(lb, ncbp).numpy(), ncbp


def _jax_select(a_lo, a_hi, b_lo, b_hi, cap):
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.select_pallas import select_bbox_pallas

    cand, lbsel = select_bbox_pallas(a_lo, a_hi, b_lo, b_hi, cap,
                                     interpret=True)
    return np.asarray(cand), np.asarray(lbsel)


def _jax_count(a_lo, a_hi, b_lo, b_hi, thr):
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.select_pallas import count_bbox_pallas

    return np.asarray(count_bbox_pallas(a_lo, a_hi, b_lo, b_hi, thr,
                                        interpret=True))


@pytest.mark.parametrize("nta,ncb,cap", [
    (5, 7, 4), (16, 300, 32), (33, 129, 16), (1, 128, 8),
])
def test_select_and_count_integer_boxes_match_jax(nta, ncb, cap):
    rng = np.random.default_rng(nta * 1000 + ncb)
    a_lo, a_hi = _int_boxes(rng, nta)
    b_lo, b_hi = _int_boxes(rng, ncb)
    cand, lbsel = S.select_bbox(*_t(a_lo, a_hi, b_lo, b_hi), cap)
    jcand, jlbsel = _jax_select(a_lo, a_hi, b_lo, b_hi, cap)
    assert cand.dtype == torch.int32 and lbsel.dtype == torch.float32
    np.testing.assert_array_equal(cand.numpy(), jcand)
    np.testing.assert_array_equal(lbsel.numpy().view(np.int32),
                                  jlbsel.view(np.int32))
    # the order is (rounded lb, chunk index), as a lexsort gives it
    _, lbm, _ = _lbs(a_lo, a_hi, b_lo, b_hi)
    ref = np.lexsort((np.tile(np.arange(ncb), (nta, 1)), lbm), axis=1)
    np.testing.assert_array_equal(cand.numpy(), ref[:, :cap])
    for q in (0.0, 0.3, 1.0):
        thr = np.quantile(lbm, q, axis=1).astype(np.float32)
        got = S.count_bbox(*_t(a_lo, a_hi, b_lo, b_hi, thr))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), _jax_count(a_lo, a_hi, b_lo, b_hi, thr))


@pytest.mark.parametrize("nta,ncb,cap", [(33, 129, 16), (40, 1000, 64)])
def test_select_float_boxes_within_one_bucket_of_jax(nta, ncb, cap):
    rng = np.random.default_rng(nta + ncb)
    a_lo, a_hi = _float_boxes(rng, nta)
    b_lo, b_hi = _float_boxes(rng, ncb)
    cand, lbsel = (x.numpy() for x in S.select_bbox(
        *_t(a_lo, a_hi, b_lo, b_hi), cap))
    _, lbm, ncbp = _lbs(a_lo, a_hi, b_lo, b_hi)
    bucket = 1 << S.key_bits(ncbp)
    assert np.all(np.diff(lbsel, axis=1) >= 0)
    assert all(len(set(r)) == cap for r in cand)
    # the port's own space: lb_sel is exactly its rounded bound
    np.testing.assert_array_equal(np.take_along_axis(lbm, cand, axis=1),
                                  lbsel)
    # within one rounding bucket of the JAX kernel's space
    jcand, jlbsel = _jax_select(a_lo, a_hi, b_lo, b_hi, cap)
    diff = lbsel.view(np.int32).astype(np.int64) - jlbsel.view(
        np.int32).astype(np.int64)
    assert np.max(np.abs(diff)) <= bucket
    assert np.mean(cand == jcand) > 0.9


@pytest.mark.parametrize("integer", [True, False])
def test_count_never_under_counts(integer):
    rng = np.random.default_rng(11 + integer)
    mk = _int_boxes if integer else _float_boxes
    a_lo, a_hi = mk(rng, 32)
    b_lo, b_hi = mk(rng, 513)
    lb, lbm, _ = _lbs(a_lo, a_hi, b_lo, b_hi)
    for q in (0.0, 0.05, 0.5, 1.0):
        thr = np.quantile(lbm, q, axis=1).astype(np.float32)
        cnt = S.count_bbox(*_t(a_lo, a_hi, b_lo, b_hi, thr)).numpy()
        assert np.all(cnt >= (lb <= thr[:, None]).sum(axis=1))
        assert np.all(cnt >= (lbm <= thr[:, None]).sum(axis=1))
        jcnt = _jax_count(a_lo, a_hi, b_lo, b_hi, thr)
        if integer:
            np.testing.assert_array_equal(cnt, jcnt)


def test_equal_boxes_select_lowest_chunks_first():
    a_lo = np.zeros((3, 3), np.float32)
    a_hi = np.ones((3, 3), np.float32)
    b_lo = np.tile(np.float32([10, 0, 0]), (200, 1))
    b_hi = b_lo + 1
    cand, lbsel = S.select_bbox(*_t(a_lo, a_hi, b_lo, b_hi), 16)
    np.testing.assert_array_equal(
        cand.numpy(), np.tile(np.arange(16, dtype=np.int32), (3, 1)))
    assert np.all(lbsel.numpy() == 81.0)  # 9^2, exact in the key space
    jcand, _ = _jax_select(a_lo, a_hi, b_lo, b_hi, 16)
    np.testing.assert_array_equal(cand.numpy(), jcand)


def test_mask_lb_rounds_down_keeps_order_and_matches_jax():
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.select_pallas import mask_lb as jmask

    rng = np.random.default_rng(7)
    lb = (rng.uniform(0, 1e6, (64, 256)) ** 2).astype(np.float32)
    lb[0, :4] = [0.0, np.inf, 1e-38, 3.4e38]
    m = S.mask_lb(torch.from_numpy(lb), 8192).numpy()
    fin = np.isfinite(lb)
    assert np.all(m[fin] <= lb[fin])
    assert np.isinf(m[0, 1])
    order = np.argsort(lb, axis=1, kind="stable")
    assert np.all(np.diff(np.take_along_axis(m, order, axis=1), axis=1) >= 0)
    np.testing.assert_array_equal(m.view(np.int32), np.asarray(
        jmask(jnp.asarray(lb), 8192)).view(np.int32))


@pytest.mark.parametrize("ncb_pad", [128, 1920, 3072, 8192])
def test_key_bits_and_count_slack_match_jax(ncb_pad):
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.select_pallas import _key_bits, count_slack

    assert S.key_bits(ncb_pad) == _key_bits(ncb_pad)
    assert S.count_slack(ncb_pad) == count_slack(ncb_pad)
    assert S.pad128(ncb_pad - 1) == ncb_pad


def test_cap_equal_to_ncb_selects_every_chunk():
    rng = np.random.default_rng(5)
    a_lo, a_hi = _int_boxes(rng, 9)
    b_lo, b_hi = _int_boxes(rng, 77)
    cand, lbsel = S.select_bbox(*_t(a_lo, a_hi, b_lo, b_hi), 77)
    assert np.all(np.sort(cand.numpy(), axis=1) == np.arange(77))
    jcand, jlbsel = _jax_select(a_lo, a_hi, b_lo, b_hi, 77)
    np.testing.assert_array_equal(cand.numpy(), jcand)
    np.testing.assert_array_equal(lbsel.numpy(), jlbsel)


def test_empty_tiles_and_touching_boxes():
    """A tile with no valid row spans +max to -max: every bound is +inf
    (0x7f800000), and it still orders (chunk index breaks the tie).
    Touching or overlapping boxes give gaps of +-0 that square to +0, so
    no key is negative."""
    b_lo = np.array([[0, 0, 0], [5, 5, 5], [1, 0, 0]], np.float32)
    b_hi = np.array([[1, 1, 1], [6, 6, 6], [2, 1, 1]], np.float32)
    a_lo = np.array([[FLT_MAX] * 3, [1, 1, 1], [-0.0, 0, 0]], np.float32)
    a_hi = np.array([[-FLT_MAX] * 3, [5, 5, 5], [0.0, 0, 0]], np.float32)
    cand, lbsel = S.select_bbox(*_t(a_lo, a_hi, b_lo, b_hi), 3)
    np.testing.assert_array_equal(cand.numpy()[0], [0, 1, 2])
    assert np.all(lbsel.numpy()[0].view(np.int32) == 0x7F800000)
    np.testing.assert_array_equal(cand.numpy()[1], [0, 1, 2])
    assert np.all(lbsel.numpy()[1:2, :2].view(np.int32) == 0)
    assert np.all(lbsel.numpy().view(np.int32) >= 0)
    np.testing.assert_array_equal(cand.numpy()[2], [0, 2, 1])
    thr = np.array([-np.inf, 0.0, 0.5], np.float32)
    cnt = S.count_bbox(*_t(a_lo, a_hi, b_lo, b_hi, thr)).numpy()
    np.testing.assert_array_equal(cnt, [0, 3, 1])
    np.testing.assert_array_equal(cnt, _jax_count(a_lo, a_hi, b_lo, b_hi, thr))
    jcand, jlbsel = _jax_select(a_lo, a_hi, b_lo, b_hi, 3)
    np.testing.assert_array_equal(cand.numpy(), jcand)
    np.testing.assert_array_equal(lbsel.numpy().view(np.int32),
                                  jlbsel.view(np.int32))


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(3)
    boxes = _t(*_int_boxes(rng, 4), *_int_boxes(rng, 10))
    before = (S.select_bbox.launches, S.count_bbox.launches)
    with pytest.raises(ValueError):
        S.select_bbox(*boxes, 11)
    with pytest.raises(ValueError):
        S.select_bbox(*boxes, 0)
    with pytest.raises(ValueError):
        S.select_bbox(*(x.double() for x in boxes), 4)
    with pytest.raises(ValueError):
        S.count_bbox(*boxes, torch.zeros(3))
    assert (S.select_bbox.launches, S.count_bbox.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("nta,ncb,cap", [(40, 1000, 32), (24, 700, 512),
                                         (7, 300, 300)])
def test_cuda_kernels_match_plain(nta, ncb, cap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2a and K2b have no CPU mode")
    rng = np.random.default_rng(nta + cap)
    a_lo, a_hi = _float_boxes(rng, nta)
    a_lo[0], a_hi[0] = FLT_MAX, -FLT_MAX  # one empty tile
    b_lo, b_hi = _float_boxes(rng, ncb)
    cpu = _t(a_lo, a_hi, b_lo, b_hi)
    gpu = [x.cuda() for x in cpu]
    before = (S.select_bbox.launches, S.count_bbox.launches)
    cand, lbsel = S.select_bbox(*gpu, cap)
    rcand, rlbsel = S.select_bbox_reference(*gpu, cap)
    assert torch.equal(cand, rcand)
    assert torch.equal(lbsel.view(torch.int32), rlbsel.view(torch.int32))
    assert torch.equal(cand.cpu(), S.select_bbox(*cpu, cap)[0])
    lbm = S.mask_lb(bbox_lower_bounds(*gpu), S.pad128(ncb))
    thr = torch.quantile(lbm[1:], 0.2, dim=1)
    thr = torch.cat([torch.full((1,), torch.inf, device="cuda"), thr])
    cnt = S.count_bbox(*gpu, thr)
    assert torch.equal(cnt, S.count_bbox_reference(*gpu, thr))
    assert (S.select_bbox.launches, S.count_bbox.launches) == (
        before[0] + 1, before[1] + 1)
