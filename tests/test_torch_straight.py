"""PyTorch port: the fixed-cap schedules' kernels against the JAX package's
Pallas kernels: K2c (``select_candidates``), K1b (``refine_nn_straight``),
K1c (``refine_nn_fused``) and K3b (``refine_knn_straight``).

On the CPU each wrapper runs its plain PyTorch version; the JAX side is
``select_candidates_pallas``, ``refine_nn_pallas``,
``refine_nn_pallas_fused`` and ``refine_knn_pallas`` in interpret mode, on
the same sorted inputs, 12 query tiles (not a multiple of 8). K2c's picks,
and every distance and id on integer clouds full of ties, must agree bit
for bit. Float clouds are held to the rule of test_torch_refine.py (d
within 4*eps*d, ids equal where the two best candidates are further apart):
XLA:CPU contracts the interpret-mode kernels' multiply-adds into FMAs,
eager PyTorch does not, and the CUDA kernels equal the plain versions bit
for bit on every cloud.

K2c's closed form is also held to the TPU kernel's rounds on adversarial
rows (ties, signed zeros, negative values, few finite entries, wide rows),
and K3b's design to a plain model of what it drops: the range bound of
its first step and the slots it skips by their chunk box.

The CUDA kernels are checked against the plain versions (and K1b, K1c and
K3b against K1 and K3 ungated, K2c's radix select against its first
design) by the tests marked ``cuda`` (skipped without a card) and by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.grid import CHUNK, bbox_lower_bounds
from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, _extract_k, refine_knn, refine_knn_straight,
    refine_knn_straight_reference, refine_nn, refine_nn_fused,
    refine_nn_straight, refine_nn_straight_reference, select_candidates,
    select_candidates_reference)

from test_torch_refine import _compare, jax_on_cpu
from test_torch_refine_split import _candidates, _lex_below

K = 30
N_TILES = 12


def _grid(kind, n, seed, hi=64):
    rng = np.random.default_rng(seed)
    if kind == "int":
        pts = rng.integers(0, hi, (n, 3)).astype(np.float64)
    else:
        pts = rng.uniform(0.0, hi, (n, 3))
    c = Cloud.from_numpy(pts, pad_to=N_TILES * CHUNK, device="cpu")
    return c, c.get_grid(build="device")


def _tables(kind, exclude_self, cap, hi=64):
    """(query grid, search grid, cand): each tile's ``cap`` lowest-lb
    chunks of a 16-tile search cloud (itself under ``exclude_self``)."""
    a, ga = _grid(kind, 3000, 81, hi)
    gb = ga if exclude_self else _grid(kind, 2900, 82, hi)[1]
    _, _, order = tile_bounds(ga, gb, a.n)
    return ga, gb, order[:, :cap].contiguous()


def _jax_args(qg, bg, cand):
    jax_on_cpu()
    import jax.numpy as jnp

    qt8 = jnp.pad(jnp.asarray(qg.points.numpy()), ((0, 0), (0, 5))).T
    bt8 = jnp.pad(jnp.asarray(bg.points.numpy()), ((0, 0), (0, 5))).T
    return (qt8, bt8, jnp.asarray(bg.perm.numpy())[None, :],
            jnp.asarray(cand.numpy()))


def _assert_agree(kind, got, want, qg, bg, cand, exclude_self):
    want = tuple(np.asarray(y).reshape(x.shape) for x, y in zip(got, want))
    _compare(kind, got, want, qg, bg, cand, exclude_self=exclude_self)


@pytest.mark.parametrize("cap", [16, 12])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_refine_nn_straight_matches_jax(kind, exclude_self, cap):
    """K1b's plain version against ``refine_nn_pallas`` (8 chunks a grid
    step at cap 16, 4 at cap 12)."""
    from open_pcc_metric_tpu.ops.refine_pallas import refine_nn_pallas

    qg, bg, cand = _tables(kind, exclude_self, cap)
    got = refine_nn_straight(qg.points, bg.points, bg.perm, cand,
                             exclude_self=exclude_self)
    want = refine_nn_pallas(*_jax_args(qg, bg, cand),
                            exclude_self=exclude_self, interpret=True)
    _assert_agree(kind, got, want, qg, bg, cand, exclude_self)


@pytest.mark.parametrize("cap", [16, 12])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_refine_nn_fused_matches_jax(kind, exclude_self, cap):
    """K1c's plain version (K1b's) against ``refine_nn_pallas_fused``."""
    from open_pcc_metric_tpu.ops.refine_pallas import refine_nn_pallas_fused

    qg, bg, cand = _tables(kind, exclude_self, cap)
    got = refine_nn_fused(qg.points, bg.points, bg.perm, cand,
                          exclude_self=exclude_self)
    want = refine_nn_pallas_fused(*_jax_args(qg, bg, cand),
                                  exclude_self=exclude_self, interpret=True)
    _assert_agree(kind, got, want, qg, bg, cand, exclude_self)


@pytest.mark.parametrize("exclude_self", [False, True])
def test_refine_knn_straight_matches_jax(exclude_self):
    """K3b's plain version against ``refine_knn_pallas`` (k = 30) on an
    integer lattice of 16^3 sites, where most distances tie."""
    from open_pcc_metric_tpu.ops.refine_pallas import refine_knn_pallas

    qg, bg, cand = _tables("int", exclude_self, 8, hi=16)
    got = refine_knn_straight(qg.points, bg.points, bg.perm, cand, K,
                              exclude_self=exclude_self)
    want = refine_knn_pallas(*_jax_args(qg, bg, cand), K,
                             exclude_self=exclude_self, interpret=True)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y).reshape(x.shape))
    d = got[0].numpy()
    tie = np.diff(d, axis=2) == 0
    assert tie.mean() > 0.5
    assert np.all(np.diff(got[1].numpy(), axis=2)[tie] > 0)


def _lb_cases():
    """Lower-bound matrices for K2c: (name, lb, cap)."""
    rng = np.random.default_rng(91)
    ties = rng.integers(0, 6, (12, 200)).astype(np.float32)  # ncb % 128 != 0
    ties[3, :] = np.inf  # a row without a finite entry
    ties[5, 10:] = np.inf  # 10 finite entries, cap 40 above them
    ties[7, rng.permutation(200)[:150]] = np.inf
    # the bound matrix of a cloud with empty query tiles: +inf rows
    c = Cloud.from_numpy(rng.integers(0, 64, (2000, 3)).astype(np.float64),
                         pad_to=N_TILES * CHUNK, device="cpu")
    g = c.get_grid(build="device")
    _, lb, _ = tile_bounds(g, g, c.n)
    return [("ties", torch.from_numpy(ties), 40),
            ("bounds", lb.contiguous(), 9)]


@pytest.mark.parametrize("case", [0, 1])
def test_select_candidates_matches_jax(case):
    """K2c's plain version against ``select_candidates_pallas``, all rows:
    ties to the lowest column, then column 0 once a row's finite entries
    are used up (an all-+inf row gives 0, 0, ...)."""
    from open_pcc_metric_tpu.ops.refine_pallas import select_candidates_pallas

    jax_on_cpu()
    import jax.numpy as jnp

    _, lb, cap = _lb_cases()[case]
    got = select_candidates(lb, cap)
    want = select_candidates_pallas(jnp.asarray(lb.numpy()), cap,
                                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    inf_rows = torch.isinf(lb).all(dim=1)
    assert inf_rows.any() and bool((got[inf_rows] == 0).all())


def _select_loop(lb: np.ndarray, cap: int) -> np.ndarray:
    """The TPU kernel's rounds, written out: the lowest column among each
    row's minima, then that entry masked to +inf."""
    lb = lb.astype(np.float64).copy()
    out = np.empty((lb.shape[0], cap), np.int32)
    for r in range(cap):
        pick = np.argmin(lb, axis=1)  # numpy's argmin takes the first
        out[:, r] = np.minimum(pick, lb.shape[1] - 1)
        lb[np.arange(lb.shape[0]), pick] = np.inf
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_select_candidates_closed_form_equals_the_loop(seed):
    """The plain version's closed form (a stable sort's prefix, then 0)
    against the cap rounds it stands for, on ties, +inf entries, +inf rows
    and caps above the row width."""
    rng = np.random.default_rng(seed)
    lb = rng.integers(0, 4, (64, 37)).astype(np.float32)
    lb[rng.random(lb.shape) < 0.3] = np.inf
    lb[::9] = np.inf
    for cap in (1, 5, 37, 50):
        got = select_candidates_reference(torch.from_numpy(lb), cap)
        np.testing.assert_array_equal(got.numpy(), _select_loop(lb, cap))


def test_cpu_dispatch_and_validation():
    """On CPU tensors the wrappers ARE the plain versions and count no
    launch; malformed inputs raise."""
    qg, bg, cand = _tables("int", False, 4)
    names = (select_candidates, refine_nn_straight, refine_nn_fused,
             refine_knn_straight)
    before = [f.launches for f in names]
    args = (qg.points, bg.points, bg.perm, cand)
    got = refine_nn_straight(*args)
    want = refine_nn_straight_reference(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    got = refine_knn_straight(*args, 8)
    want = refine_knn_straight_reference(*args, 8)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    lb = torch.rand(5, 7)
    assert torch.equal(select_candidates(lb, 3),
                       select_candidates_reference(lb, 3))
    assert [f.launches for f in names] == before
    with pytest.raises(ValueError):
        refine_nn_straight(qg.points, bg.points, bg.perm, cand.long())
    with pytest.raises(ValueError):
        refine_knn_straight(*args, 33)
    with pytest.raises(ValueError):
        select_candidates(lb[0], 3)
    with pytest.raises(ValueError):
        select_candidates(lb, 0)
    for splits in (0, 9):
        with pytest.raises(ValueError):
            refine_nn_straight(*args, splits=splits)


def _adversarial_rows():
    """(name, lb, cap) for K2c: rows that a key, a sort or a tie rule can
    get wrong."""
    rng = np.random.default_rng(93)
    inf = np.float32(np.inf)
    few = rng.integers(0, 5, (6, 96)).astype(np.float32)
    few[0, 20:] = inf  # f < cap
    few[1, 32:] = inf  # f == cap
    few[2] = inf  # f == 0
    few[3, rng.permutation(96)[:70]] = inf
    neg = rng.normal(0.0, 100.0, (6, 1000)).astype(np.float32)
    neg[:, ::7] = np.round(neg[:, ::7])  # ties among negatives
    neg[1, ::5] = -inf
    neg[2, ::3] = inf
    wide = rng.integers(0, 200, (8, 1920)).astype(np.float32)
    wide[3] = inf
    wide[5, 300:] = inf  # f < 512
    return [
        ("all ties", np.full((4, 300), 7.0, np.float32), 40),
        ("signed zeros", rng.choice(np.array([-0.0, 0.0, 1.0], np.float32),
                                    (6, 257)), 64),
        ("negative values", neg, 48),
        ("few finite", few, 32),
        ("cap == ncb", few[3:], 96),
        ("cap > ncb", few, 100),
        ("cap 512", wide, 512),
        ("ncb 37", rng.integers(0, 4, (9, 37)).astype(np.float32), 5),
    ]


@pytest.mark.parametrize("case", range(8))
def test_select_candidates_adversarial_rows_equal_the_loop(case):
    """K2c's plain version against the TPU kernel's rounds on the rows the
    card tests give the kernel: -0.0 and +0.0 tie (the lower column
    first), negative values and -inf order below the rest."""
    _, lb, cap = _adversarial_rows()[case]
    got = select_candidates_reference(torch.from_numpy(lb), cap)
    np.testing.assert_array_equal(got.numpy(), _select_loop(lb, cap))


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_straight_design_drops_no_member(exclude_self):
    """K3b's design on an integer lattice full of ties: T, the k-th
    smallest of the two smallest d of each of 32 strided groups over the
    first step's 8 chunks (self column excluded), is never below a row's
    final k-th distance; and dropping every candidate not below (T,
    INT32_MAX), then every later slot whose chunk box every row of its tile
    is bounded beyond T from, leaves the k-best unchanged."""
    k, step = K, 8
    qg, bg, cand = _tables("int", exclude_self, 12, hi=16)
    args = (qg.points, bg.points, bg.perm, cand)
    nt, w = cand.shape
    want = refine_knn_straight_reference(*args, k, exclude_self=exclude_self)
    d, ids = _candidates(*args, torch.full((nt,), w, dtype=torch.int32),
                         None, exclude_self)
    slot = torch.arange(w * CHUNK) // CHUNK
    first = torch.where(slot < step, d, torch.inf)
    two = first.reshape(nt, CHUNK, -1, 32).topk(2, dim=2, largest=False)[0]
    td = two.reshape(nt, CHUNK, 64).sort(dim=2).values[..., k - 1]
    assert bool((td >= want[0][..., -1]).all())
    lb = bbox_lower_bounds(qg.points, qg.points, bg.bbox_lo, bg.bbox_hi)
    lb = lb.reshape(nt, CHUNK, -1).gather(
        2, cand.long()[:, None, :].expand(nt, CHUNK, w))
    needed = (lb <= td[..., None]).any(dim=1)  # (nt, w) slots some row needs
    needed[:, :step] = True
    keep = (needed.repeat_interleave(CHUNK, dim=1)[:, None, :]
            & _lex_below(d, ids, td[..., None], INT_MAX))
    assert int((~needed).sum()) > 0  # some slot is skipped
    assert int((~keep & torch.isfinite(d)).sum()) > 0  # the bound bites
    got = refine_knn_straight(*args, k, exclude_self=exclude_self,
                              boxes=(bg.bbox_lo, bg.bbox_hi))
    model = _extract_k(torch.where(keep, d, torch.inf),
                       torch.where(keep, ids, INT_MAX), k)
    for x, y, z in zip(model, want, got):
        assert torch.equal(x, y) and torch.equal(y, z)


def test_knn_straight_boxes_cpu_dispatch_and_validation():
    """K3b's chunk boxes: on CPU tensors the wrapper is the plain version
    with or without them and counts no launch; boxes of another shape or
    dtype raise, on every device."""
    qg, bg, cand = _tables("int", False, 6)
    args = (qg.points, bg.points, bg.perm, cand)
    before = refine_knn_straight.launches
    want = refine_knn_straight_reference(*args, 8)
    got = refine_knn_straight(*args, 8, boxes=(bg.bbox_lo, bg.bbox_hi))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert refine_knn_straight.launches == before
    for boxes in ((bg.bbox_lo,), (bg.bbox_lo[:-1], bg.bbox_hi[:-1]),
                  (bg.bbox_lo.double(), bg.bbox_hi.double()),
                  (bg.bbox_lo, bg.bbox_hi.reshape(-1))):
        with pytest.raises(ValueError):
            refine_knn_straight(*args, 8, boxes=boxes)
    lb = torch.rand(5, 7)
    assert torch.equal(select_candidates(lb, 3, rounds=True),
                       select_candidates_reference(lb, 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _to(g, dev):
    return type(g)(*(x.to(dev) for x in g))


def _bit_equal(x, y):
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_select_candidates_matches_plain_version(cuda_device):
    """K2c on the card against its plain version on the same card: ties,
    +inf rows, rows staged in shared memory beyond 48 KB (ncb 20000) and
    rows read from device memory beyond the opt-in limit (ncb 60000)."""
    cases = [(lb, cap) for _, lb, cap in _lb_cases()]
    rng = np.random.default_rng(92)
    for ncb, cap in ((20000, 64), (60000, 16)):
        lb = rng.integers(0, 50, (6, ncb)).astype(np.float32)
        lb[2] = np.inf
        cases.append((torch.from_numpy(lb), cap))
    for lb, cap in cases:
        lb = lb.to(cuda_device)
        before = select_candidates.launches
        got = select_candidates(lb, cap)
        torch.cuda.synchronize()
        assert select_candidates.launches == before + 1
        assert torch.equal(got, select_candidates_reference(lb, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
def test_cuda_straight_refines_match_plain_version(kind, cuda_device):
    """K1b and K1c on the card against their plain version and K1 ungated,
    and K3b against its plain version and K3 ungated, bit for bit: cross
    and self, 8, 4 and 1 chunks a step, compacted tiles."""
    for exclude_self, cap in ((False, 16), (True, 12), (False, 7)):
        qg, bg, cand = _tables(kind, exclude_self, cap)
        qg, bg, cand = _to(qg, cuda_device), _to(bg, cuda_device), \
            cand.to(cuda_device)
        tiles = torch.tensor([11, 0, 5], dtype=torch.int32, device=cuda_device)
        for kw in (dict(exclude_self=exclude_self),
                   dict(exclude_self=exclude_self, tiles=tiles)):
            c = cand if "tiles" not in kw else cand[tiles.long()].contiguous()
            args = (qg.points, bg.points, bg.perm, c)
            want = refine_nn_straight_reference(*args, **kw)
            k1 = refine_nn(*args, **kw)
            for fn in (refine_nn_straight, refine_nn_fused):
                before = fn.launches
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                assert fn.launches == before + 1
                assert all(_bit_equal(x, y) for x, y in zip(got, want))
                assert all(_bit_equal(x, y) for x, y in zip(got, k1))
            for k in (K, 8):
                before = refine_knn_straight.launches
                got = refine_knn_straight(*args, k, **kw)
                torch.cuda.synchronize()
                assert refine_knn_straight.launches == before + 1
                want_k = refine_knn_straight_reference(*args, k, **kw)
                k3 = refine_knn(*args, k, **kw)
                assert all(_bit_equal(x, y) for x, y in zip(got, want_k))
                assert all(_bit_equal(x, y) for x, y in zip(got, k3))


@pytest.mark.cuda
def test_cuda_select_candidates_adversarial_rows(cuda_device):
    """K2c's radix select and its first design on the card against the
    plain version on the CPU (a comparison sort: -0.0 and +0.0 tie) on the
    adversarial rows, and a row whose keys and picks pass the shared-memory
    limit while the first design still stages it (ncb 57300, cap 64)."""
    cases = [(lb, cap) for _, lb, cap in _adversarial_rows()]
    rng = np.random.default_rng(94)
    lb = rng.integers(0, 30, (3, 57300)).astype(np.float32)
    lb[1, 1000:] = np.inf
    cases.append((lb, 64))
    for lb, cap in cases:
        want = select_candidates_reference(torch.from_numpy(lb), cap)
        lb = torch.from_numpy(lb).to(cuda_device)
        for rounds in (False, True):
            before = select_candidates.launches
            got = select_candidates(lb, cap, rounds=rounds)
            torch.cuda.synchronize()
            assert select_candidates.launches == before + 1
            assert torch.equal(got.cpu(), want), (lb.shape, cap, rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lattice", "jittered"])
def test_cuda_refine_knn_straight_steps_and_slot_skip(kind, cuda_device):
    """K3b on a 40-chunk table (5 steps of 8 slots, the last partial) on the
    card: d and id bit-identical to its plain version and to K3 ungated,
    for k in {1, 8, 30, 32}, cross and self, with and without the chunk
    boxes (the slot skip), on a lattice full of ties and a jittered cloud."""
    rng = np.random.default_rng(95)
    pts = rng.integers(0, 48, (10000, 3)).astype(np.float64)
    if kind == "jittered":
        pts += rng.uniform(-0.5, 0.5, pts.shape)
    c = Cloud.from_numpy(pts, pad_to=40 * CHUNK, device="cpu")
    g = _to(c.get_grid(build="device"), cuda_device)
    other = Cloud.from_numpy(pts[::2] + 0.25, pad_to=40 * CHUNK, device="cpu")
    go = _to(other.get_grid(build="device"), cuda_device)
    for gb, exclude_self in ((g, True), (go, False)):
        _, _, order = tile_bounds(g, gb, c.n)
        cand = order[:, :37].contiguous()
        args = (g.points, gb.points, gb.perm, cand)
        for k in (1, 8, 30, 32):
            want = refine_knn_straight_reference(*args, k,
                                                 exclude_self=exclude_self)
            k3 = refine_knn(*args, k, exclude_self=exclude_self)
            for boxes in (None, (gb.bbox_lo, gb.bbox_hi)):
                got = refine_knn_straight(*args, k, exclude_self=exclude_self,
                                          boxes=boxes)
                torch.cuda.synchronize()
                for x, y, z in zip(got, want, k3):
                    assert _bit_equal(x, y) and _bit_equal(x, z), (
                        kind, exclude_self, k, boxes is None)
