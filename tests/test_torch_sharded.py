"""PyTorch port: the ring (``parallel/sharded.py``) against the JAX package's.

The port's mesh is one process's grid of torch devices, and a device may
fill several slots: here every mesh is made of CPU slots
(``make_mesh(devices=["cpu"] * 8, dp=...)``), the counterpart of the JAX
tests' 8 virtual CPU devices, on which the JAX side runs under
``jax.shard_map`` as its own tests run it. Inputs are made from numpy
seeds; each JAX program is built and run once per module (fixtures), and
several searches share one program.

Tolerances: the ring searches' ids and payload rows, and the float64
pruned ring against the JAX package's on the same refine route, are held
bit for bit (distances, original ids, payload rows, overflow flags); the
brute rings' and the k-NN rings' distances within 1e-15 relative of
JAX's (one rounding: XLA:CPU adds the three squares in another order or
contracts them into FMAs); the float32 ring through K1 (``refine_nn``,
its plain version on these CPU slots) on the kernel route's schedule
against the plain route's schedule and JAX's plain route, and one slot's
refine against a numpy oracle, bit for bit on every valid row (integer
points: every distance exact); float64 stats against the port's single-device
``pair_stats`` within 1e-10 relative (the slots' partial sums are added
in another order), float32 pruned stats within 1e-5 relative or 1e-7
absolute, the bar of the JAX package's own ring tests; float64 ring
normals within 1e-9 of JAX's in |dot|.
"""
import os

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import refine
from open_pcc_metric_tpu_torch.ops.fused import finalize_stats, pair_stats
from open_pcc_metric_tpu_torch.ops.grid import CHUNK, bbox_lower_bounds
from open_pcc_metric_tpu_torch.ops.nn_pruned import lb_order
from open_pcc_metric_tpu_torch.parallel import (
    make_mesh, ring_knn_coords, ring_knn_coords_pruned, ring_nn,
    ring_nn_pruned, ring_normals, sharded, sharded_pair_stats)
from open_pcc_metric_tpu_torch.parallel.sharded import (
    _refine_local_pallas, _ring_step0_counted, _shard,
    _tile_bounds_local, pack_sorted_frames, sharded_pair_stats_pruned,
    sharded_pair_stats_pruned_auto)

from test_torch_refine import jax_on_cpu

F64_RTOL = 1e-10
# The brute and k-NN rings' distances against JAX's: XLA:CPU sums the three
# squares in another order than ((dx^2 + dy^2) + dz^2), or with FMAs.
BRUTE_D_RTOL = 1e-15
F32_RTOL, F32_ATOL = 1e-5, 1e-7
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """The ring runs many small CPU ops a step, slot after slot. Where
    pytest-xdist runs several workers on the machine's cores, torch's
    intra-op threads beyond a worker's share only wait on each other
    (seconds a test become a minute), so the module takes its share."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


def _row(dp=1, slots=CPU8):
    """Mesh row 0's devices of a CPU mesh."""
    return list(make_mesh(devices=slots, dp=dp).devices[0])


def _slots(x, devices):
    """A (P, ...) numpy array or torch tensor cut into one block a slot."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return _shard(x, devices)


def _cat(xs):
    return torch.cat([x.cpu() for x in xs]).numpy()


def _cloud(pts, p, dtype=torch.float64, **kw):
    return Cloud.from_numpy(pts, dtype=dtype, pad_to=p, device="cpu", **kw)


def _jax_run(fn, args, n_rows, n_flags=0, dp=1):
    """``fn`` under the JAX package's 8-device mesh (``dp`` frame rows)
    over args with a leading frames axis of 1: ``n_rows`` sharded outputs,
    then ``n_flags`` replicated ones, each as numpy without that axis."""
    jax = jax_on_cpu()
    from jax.sharding import PartitionSpec as P
    from open_pcc_metric_tpu.parallel import make_mesh as jmesh

    mapped = jax.jit(jax.shard_map(
        fn, mesh=jmesh(8, dp=dp), in_specs=(P(None, "points"),) * len(args),
        out_specs=(P(None, "points"),) * n_rows + (P(None),) * n_flags))
    return [np.asarray(o)[0] for o in mapped(*[a[None] for a in args])]


def _unsort(x, perm, n):
    inv = np.zeros(len(perm), np.int64)
    inv[np.asarray(perm)] = np.arange(len(perm))
    return np.asarray(x)[inv][:n]


# ------------------------------------------------------------------ the mesh


def test_mesh_shapes():
    m = make_mesh(devices=CPU8, dp=2)
    assert m.devices.shape == (2, 4)
    assert m.axis_names == ("frames", "points")
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_mesh(4, devices=CPU8).devices.shape == (1, 4)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(devices=["cpu"] * 6, dp=4)
    if torch.cuda.is_available():
        assert make_mesh().devices.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


# ------------------------------------------------------------ the brute ring


@pytest.fixture(scope="module")
def brute_case():
    """tests/test_sharded.py's ring_nn inputs (float64, 600 and 500 points
    padded to 1024) with its rank-3 payload, and the JAX ring's (d, ids)
    a->b, its payload rows and (d, ids) a->a without self pairs, on 8
    slots."""
    rng = np.random.default_rng(0)
    na, nb, p = 600, 500, 1024
    a = _cloud(rng.uniform(0, 100, (na, 3)), p)
    b = _cloud(rng.uniform(0, 100, (nb, 3)), p)
    pay = rng.uniform(size=(p, 2, 3))
    from open_pcc_metric_tpu.parallel import ring_nn as jring

    def fn(ap, bp, pl):
        d, i, (best,) = jring(ap[0], bp[0], payloads=(pl[0],))
        ds, is_, _ = jring(ap[0], ap[0], exclude_self=True)
        return d[None], i[None], best[None], ds[None], is_[None]

    jax_on_cpu()
    want = _jax_run(fn, [a.points.numpy(), b.points.numpy(), pay], 5)
    return a, b, pay, want


@pytest.mark.parametrize("dp", [1, 2])
def test_ring_nn_matches_jax_and_oracle(brute_case, dp):
    import oracle

    a, b, _, (jd, ji, _, _, _) = brute_case
    row = _row(dp)
    d, i, _ = ring_nn(_slots(a.points, row), _slots(b.points, row))
    d, i = _cat(d), _cat(i)
    oidx, od = oracle.nn_bruteforce(a.points[:a.n].numpy(),
                                    b.points[:b.n].numpy())
    np.testing.assert_array_equal(i[:a.n], oidx)
    np.testing.assert_allclose(d[:a.n], od, rtol=1e-12)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=BRUTE_D_RTOL, atol=0)


def test_ring_nn_self_exclusion(brute_case):
    import oracle

    a, _, _, (_, _, _, jds, jis) = brute_case
    row = _row()
    d, i, _ = ring_nn(_slots(a.points, row), _slots(a.points, row),
                      exclude_self=True)
    pts = a.points[:a.n].numpy()
    oidx, _ = oracle.nn_bruteforce(pts, pts, exclude_self=True)
    np.testing.assert_array_equal(_cat(i)[:a.n], oidx)
    np.testing.assert_array_equal(_cat(i), jis)
    np.testing.assert_allclose(_cat(d), jds, rtol=BRUTE_D_RTOL, atol=0)


def test_ring_nn_payload_rank3(brute_case):
    """ring_nn accepts payloads of any rank: each query gets its winner's
    (2, 3) row, as JAX's does."""
    a, b, pay, (_, _, jbest, _, _) = brute_case
    row = _row()
    _, i, (best,) = ring_nn(_slots(a.points, row), _slots(b.points, row),
                            payloads=(_slots(pay, row),))
    i = _cat(i)
    np.testing.assert_array_equal(_cat(best)[:a.n], pay[i[:a.n]])
    np.testing.assert_array_equal(_cat(best), jbest)


# ------------------------------------------------------------ the pruned ring


def _voxels(seed, na, nb, hi, p, dtype, same=False):
    rng = np.random.default_rng(seed)
    A = rng.integers(0, hi, (na, 3)).astype(float)
    B = A if same else rng.integers(0, hi, (nb, 3)).astype(float)
    a = _cloud(A, p, dtype)
    return A, B, a, (a if same else _cloud(B, p, dtype))


def _pruned_inputs(a, b):
    """(queries, search points, perm, box corners, payload) of a->b: the
    payload is the search rows' points and original ids."""
    ga, gb = a.get_grid(), b.get_grid()
    pay = torch.cat([gb.points, gb.perm.to(gb.points.dtype)[:, None]], dim=1)
    return [ga.points, gb.points, gb.perm, gb.bbox_lo, gb.bbox_hi, pay]


@pytest.fixture(scope="module")
def pruned_case():
    """tests/test_sharded.py's pruned-ring inputs in float64 (integer voxels:
    many exact ties): a->b and a->a at cap 8 (2048 rows, 1 chunk a slot),
    and the duplicate-heavy overflow pair at cap 1; and the JAX ring's
    (d, ids, payload, overflow) of each, from one program."""
    cross = _voxels(7, 900, 800, 64, 2048, torch.float64)
    self_ = _voxels(7, 900, 900, 64, 2048, torch.float64, same=True)
    dup = _voxels(8, 900, 800, 8, 2048, torch.float64)
    cases = [(cross, False, 8), (self_, True, 8), (dup, False, 1)]
    jax = jax_on_cpu()
    from open_pcc_metric_tpu.parallel import ring_nn_pruned as jring

    def fn(*args):
        outs, flags = [], []
        for c, (case, excl, cap) in enumerate(cases):
            ap, bp, perm, lo, hi, pl = (x[0] for x in args[6 * c:6 * c + 6])
            d, i, pw, ovf = jring(
                ap, bp, perm, lo, hi, case[2].n, case[3].n, payload=pl,
                exclude_self=excl, cap=cap, refine_impl="xla")
            outs += [d[None], i[None], pw[None]]
            flags.append((jax.lax.pmax(ovf.astype(np.int32), "points")
                          > 0)[None])
        return (*outs, *flags)

    args = [x.numpy() for case, _, _ in cases
            for x in _pruned_inputs(case[2], case[3])]
    got = _jax_run(fn, args, 9, 3)
    want = [got[3 * c:3 * c + 3] + [bool(got[9 + c])] for c in range(3)]
    return cases, want


def _port_pruned(a, b, row, exclude_self=False, cap=8, refine_impl="auto"):
    qa, pb, perm, lo, hi, pay = _pruned_inputs(a, b)
    d, i, pw, ovf = ring_nn_pruned(
        _slots(qa, row), _slots(pb, row), _slots(perm, row),
        _slots(lo, row), _slots(hi, row), a.n, b.n,
        payload=_slots(pay, row), exclude_self=exclude_self, cap=cap,
        refine_impl=refine_impl)
    return _cat(d), _cat(i), _cat(pw), bool(any(bool(o) for o in ovf))


@pytest.mark.parametrize("case", [0, 1], ids=["a->b", "self"])
def test_ring_nn_pruned_matches_jax_and_oracle(pruned_case, case):
    """float64 (the plain refine on both sides): d, original ids, payload
    rows and the overflow flag bit-identical to JAX's; the ids are the
    oracle's, ties included."""
    import oracle

    cases, want = pruned_case
    (A, B, a, b), excl, cap = cases[case]
    got = _port_pruned(a, b, _row(), excl, cap)
    for g, w in zip(got[:3], want[case][:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[case][3] is False
    perm = a.get_grid().perm
    oidx, od = oracle.nn_bruteforce(A, B, exclude_self=excl)
    np.testing.assert_array_equal(_unsort(got[1], perm, a.n), oidx)
    np.testing.assert_allclose(_unsort(got[0], perm, a.n), od, rtol=1e-12)
    np.testing.assert_array_equal(
        _unsort(got[2], perm, a.n)[:, 3].astype(np.int64), oidx)


def test_ring_nn_pruned_overflow_escalates(pruned_case):
    """cap=1 on a duplicate-heavy cloud is exact or flagged (never silently
    inexact), with JAX's flag and JAX's rows; the slot's full chunk count
    is exact and quiet."""
    import oracle

    cases, want = pruned_case
    (A, B, a, b), _, _ = cases[2]
    perm = a.get_grid().perm
    oidx, od = oracle.nn_bruteforce(A, B)
    d1, i1, pw1, ovf1 = _port_pruned(a, b, _row(), cap=1)
    for g, w in zip((d1, i1, pw1), want[2][:3]):
        np.testing.assert_array_equal(g, w)
    assert ovf1 == want[2][3]
    exact1 = (np.array_equal(_unsort(i1, perm, a.n), oidx)
              and np.allclose(_unsort(d1, perm, a.n), od))
    assert exact1 or ovf1
    dF, iF, _, ovfF = _port_pruned(a, b, _row(), cap=256 // CHUNK)
    assert not ovfF
    np.testing.assert_array_equal(_unsort(iF, perm, a.n), oidx)


@pytest.fixture(scope="module")
def float_case():
    """An integer voxel pair in float32 (3500 and 3600 points padded to
    4096, many ties; every distance exact), with the JAX ring's (d, ids,
    payload) through its plain route ("xla") on 1 and 4 slots, a->b and
    a->a without self pairs, from one program a slot count."""
    case = _voxels(13, 3500, 3600, 64, 4096, torch.float32)
    _, _, a, b = case
    jax = jax_on_cpu()
    from open_pcc_metric_tpu.parallel import ring_nn_pruned as jring

    def fn(*args):
        outs, flags = [], []
        for c, excl in enumerate((False, True)):
            ap, bp, perm, lo, hi, pl = (x[0] for x in args[6 * c:6 * c + 6])
            d, i, pw, ovf = jring(ap, bp, perm, lo, hi, a.n,
                                  a.n if excl else b.n, payload=pl,
                                  exclude_self=excl, cap=8, refine_impl="xla")
            outs += [d[None], i[None], pw[None]]
            flags.append((jax.lax.pmax(ovf.astype(np.int32), "points")
                          > 0)[None])
        return (*outs, *flags)

    args = [x.numpy() for other in (b, a) for x in _pruned_inputs(a, other)]
    want = {}
    for slots, dp in ((1, 8), (4, 2)):
        got = _jax_run(fn, args, 6, 2, dp=dp)
        for c, excl in enumerate((False, True)):
            want[slots, excl] = got[3 * c:3 * c + 3] + [bool(got[6 + c])]
    return case, want


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("excl", [False, True], ids=["a->b", "self"])
@pytest.mark.parametrize("impl", ["xla", "jax"])
def test_k1_route_matches_plain_refine(float_case, slots, excl, impl):
    """The ring in float32 on the kernel route's schedule ("pallas": K1
    through ``refine_nn``, its plain version on these CPU slots, with the
    counted step 0 and gated rotations) equals the plain route's schedule
    ("xla": ungated, as the JAX package's plain refine runs), and the JAX
    package's ring on its plain route, bit for bit on every valid row: d,
    original ids, payload rows, and no overflow. One slot (16 chunks)
    takes the counted step 0 (probe and gated extension); four slots (4
    chunks each) rotate with per-tile gates."""
    (_, _, a, b), want = float_case
    if excl:
        b = a
    row = ["cpu"] * slots
    k1 = _port_pruned(a, b, row, excl, cap=8, refine_impl="pallas")
    if impl == "xla":
        plain = _port_pruned(a, b, row, excl, cap=8, refine_impl="xla")
    else:
        plain = want[slots, excl]
    assert k1[3] == plain[3] is False
    for g, w in zip(k1[:3], plain[:3]):
        np.testing.assert_array_equal(g[:a.n], w[:a.n])


def test_auto_resolves_by_device_dtype_and_env(float_case, monkeypatch):
    """"auto" takes the kernel route's schedule on a CUDA slot in float32
    and the plain route's elsewhere; float64 never takes it; the refine is
    ``refine_nn`` in float32 on every route; PCC_REFINE_IMPL (which names
    single-device schedules) changes nothing; any other refine_impl
    raises."""
    (_, _, a, b), _ = float_case
    cuda = torch.device("cuda", 0)
    assert sharded._kernel_schedule("auto", cuda, torch.float32)
    assert not sharded._kernel_schedule("auto", cuda, torch.float64)
    assert not sharded._kernel_schedule("auto", torch.device("cpu"),
                                        torch.float32)
    assert not sharded._kernel_schedule("xla", cuda, torch.float32)
    assert sharded._kernel_schedule("pallas", torch.device("cpu"),
                                    torch.float32)
    calls = []
    real = refine.refine_nn

    def spy(*args, **kw):
        calls.append(kw.get("ncand") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(sharded, "refine_nn", spy)
    monkeypatch.delenv("PCC_REFINE_IMPL", raising=False)
    plain = _port_pruned(a, b, ["cpu"] * 2)
    assert calls == [False] * 4  # 2 slots x (step 0 + one rotation)
    for env in ("pallas", "adaptive", "xla"):
        monkeypatch.setenv("PCC_REFINE_IMPL", env)
        calls.clear()
        got = _port_pruned(a, b, ["cpu"] * 2)
        assert calls == [False] * 4
        np.testing.assert_array_equal(got[1], plain[1])
    calls.clear()
    k1 = _port_pruned(a, b, ["cpu"] * 2, refine_impl="pallas")
    assert calls == [False, False, True, True]  # gated rotations
    np.testing.assert_array_equal(k1[1][:a.n], plain[1][:a.n])
    calls.clear()
    _, _, a64, b64 = _voxels(13, 900, 800, 64, 2048, torch.float64)
    _port_pruned(a64, b64, ["cpu"] * 2, refine_impl="pallas")
    assert calls == []  # float64: refine_nn_reference
    for bad in ("adaptive", "pallas_interpret", "default"):
        with pytest.raises(ValueError, match="refine_impl"):
            _port_pruned(a, b, ["cpu"] * 2, refine_impl=bad)
        with pytest.raises(ValueError, match="refine_impl"):
            sharded_pair_stats_pruned(
                make_mesh(devices=["cpu"]), pack_sorted_frames([a], [b]),
                refine_impl=bad)


def _refine_oracle(A, B, perm, payload, cand, ncand, exclude_self):
    """numpy: each query row's lexicographic minimum of (d, original id)
    over the live chunks of its tile's table, and the winner's payload row
    (+inf, INT_MAX and no row where nothing is live)."""
    ntl = cand.shape[0]
    d_out = np.full(ntl * CHUNK, np.inf)
    i_out = np.full(ntl * CHUNK, refine.INT_MAX, np.int64)
    p_out = np.zeros((ntl * CHUNK, payload.shape[1]))
    for t in range(ntl):
        if ncand[t] == 0:
            continue
        cols = np.concatenate([np.arange(c * CHUNK, (c + 1) * CHUNK)
                               for c in cand[t, :ncand[t]]]).astype(np.int64)
        for r in range(t * CHUNK, (t + 1) * CHUNK):
            d = ((B[cols].astype(np.float64) - A[r]) ** 2).sum(axis=1)
            if exclude_self:
                d = np.where(cols == r, np.inf, d)
            live = cols[d == d.min()] if np.isfinite(d.min()) else cols[:0]
            if live.size:
                win = live[np.argmin(perm[live])]
                d_out[r], i_out[r], p_out[r] = d.min(), perm[win], payload[win]
    return d_out, i_out, p_out


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_refine_local_pallas_matches_plain(exclude_self, dtype):
    """One slot's refine (K1 through ``refine_nn`` in float32, its plain
    version here; ``refine_nn_reference`` in float64) equals a numpy
    oracle on a gated table, with original-id ties on integer points (every
    distance exact), a tile gated to nothing, the inverse-permutation
    payload gather and positional self-exclusion."""
    rng = np.random.default_rng(11)
    ntl, ncl = (4, 4) if exclude_self else (3, 4)
    cap = 3
    A = rng.integers(0, 64, (ntl * CHUNK, 3)).astype(np.float64)
    B = A if exclude_self else rng.integers(
        0, 64, (ncl * CHUNK, 3)).astype(np.float64)
    perm = rng.permutation(ncl * CHUNK).astype(np.int32)
    payload = np.concatenate([B, perm[:, None]], axis=1)
    cand = np.stack([
        np.concatenate(([t % ncl], rng.integers(0, ncl, cap - 1)))
        for t in range(ntl)]).astype(np.int32)
    ncand = (np.arange(ntl) % (cap + 1)).astype(np.int32)
    d_k, i_k, p_k = sharded._refine_local_pallas(
        torch.from_numpy(A).to(dtype), torch.from_numpy(B).to(dtype),
        torch.from_numpy(perm), torch.from_numpy(payload).to(dtype),
        torch.from_numpy(cand), torch.from_numpy(ncand), nsh=1,
        exclude_self=exclude_self)
    d_x, i_x, p_x = _refine_oracle(A, B, perm, payload, cand, ncand,
                                   exclude_self)
    assert d_k.dtype == dtype
    np.testing.assert_array_equal(d_k.numpy(), d_x)
    np.testing.assert_array_equal(i_k.numpy(), i_x)
    won = i_x != refine.INT_MAX
    assert (~won).sum() == CHUNK  # the tile gated to nothing
    np.testing.assert_array_equal(p_k.numpy()[won], p_x[won])


@pytest.mark.parametrize("exclude_self", [False, True])
def test_ring_step0_counted_matches_jax(exclude_self):
    """The port's counted step 0 through K1 (its plain version here) equals
    the JAX package's ``_ring_step0_counted`` fed its plain refine
    (``_refine_local``, out of mesh), on every valid row: d, ids, payload,
    and no overflow (cap0 = ncl makes the JAX side a full refine)."""
    jax = jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.parallel import sharded as jsh

    rng = np.random.default_rng(13)
    A = rng.integers(0, 64, (1800, 3)).astype(float)
    B = A if exclude_self else rng.integers(0, 64, (1900, 3)).astype(float)
    p = 2048
    a = _cloud(A, p, torch.float32)
    b = a if exclude_self else _cloud(B, p, torch.float32)
    ga, gb = a.get_grid(), b.get_grid()
    ntl = ncl = p // CHUNK
    valid_t, a_lo, a_hi = _tile_bounds_local(ga.points, 0, a.n)
    lb0 = bbox_lower_bounds(a_lo, a_hi, gb.bbox_lo, gb.bbox_hi)
    cand0 = lb_order(lb0)[:, :ncl]
    payload = torch.cat([gb.points, gb.perm.to(torch.float32)[:, None]], 1)

    def refine(b_cur, perm_cur, pay_cur, cand, ncand, excl):
        return _refine_local_pallas(ga.points, b_cur, perm_cur, pay_cur,
                                    cand, ncand, 1, excl)

    got = _ring_step0_counted(refine, lb0, cand0, 4, ncl, valid_t, gb.points,
                              gb.perm, payload, exclude_self)

    def jstep(qa, pb, perm, lb, cand, pay, vt):
        def jrefine(b_cur, perm_cur, pay_cur, cand, ncand, b_row0, excl):
            return jsh._refine_local(qa, cand, b_cur, perm_cur, pay_cur, 0,
                                     b_row0, excl)

        eps = jnp.asarray(jnp.finfo(jnp.float32).eps, jnp.float32)
        return jsh._ring_step0_counted(jrefine, lb, cand, 4, ncl, vt, ntl,
                                       eps, pb, perm, pay, 0, exclude_self)

    want = jax.jit(jstep)(*[x.numpy() for x in (
        ga.points, gb.points, gb.perm, lb0, cand0, payload, valid_t)])
    assert not bool(got[3]) and not bool(want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy()[:a.n], np.asarray(w)[:a.n])


def test_ring_nn_pruned_work_reduction(monkeypatch):
    """Pruning engages: on a 62 x 62 voxel plane (3844 points, 4096 rows)
    over two slots of 8 chunks, the rotation refines through K1 (its plain
    version) only the chunks the certificate qualifies, 20 of the 128
    (tile, chunk) pairs a brute rotation refines, and the self search is
    the oracle's."""
    import oracle

    x, y = np.meshgrid(np.arange(62.0), np.arange(62.0))
    A = np.stack([x.ravel(), y.ravel(), np.zeros(x.size)], axis=1)
    a = _cloud(A, 4096, torch.float32)
    live = []
    real = refine.refine_nn

    def spy(*args, **kw):
        if kw.get("ncand") is not None:
            live.append(kw["ncand"])
        return real(*args, **kw)

    monkeypatch.setattr(sharded, "refine_nn", spy)
    d, i, _, ovf = _port_pruned(a, a, ["cpu"] * 2, True, cap=8,
                                refine_impl="pallas")
    assert not ovf
    oidx, _ = oracle.nn_bruteforce(A, A, exclude_self=True)
    np.testing.assert_array_equal(_unsort(i, a.get_grid().perm, a.n), oidx)
    assert len(live) == 2  # one gated rotation a slot
    ntl = ncl = 8
    refined = float(torch.cat(live).sum()) / (2 * ntl * ncl)
    assert refined < 0.25, f"pruning ineffective: {refined:.1%} refined"


# ------------------------------------------------------------------ ring k-NN


@pytest.fixture(scope="module")
def knn_case():
    """tests/test_sharded.py's k-NN inputs (1000 points in float64 padded
    to 2048, k = 12) and a plane of 900 points, with the JAX ring's brute
    and pruned (d, coords) and overflow and its normals of the plane."""
    rng = np.random.default_rng(9)
    a = _cloud(rng.uniform(0, 30, (1000, 3)), 2048)
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 10, (900, 2))
    plane = _cloud(np.concatenate([xy, 0.25 * np.ones((900, 1))], axis=1),
                   1024)
    jax = jax_on_cpu()
    from open_pcc_metric_tpu.parallel import ring_normals as jnormals
    from open_pcc_metric_tpu.parallel.sharded import (
        ring_knn_coords as jbrute, ring_knn_coords_pruned as jpruned)

    n = a.n

    def fn(apts, blo, bhi, pp):
        d1, c1 = jbrute(apts[0], apts[0], k=12)
        d2, c2, ovf = jpruned(apts[0], apts[0], blo[0], bhi[0], n, k=12,
                              cap=8)
        ovf = jax.lax.pmax(ovf.astype(np.int32), "points") > 0
        nrm = jnormals(pp[0])
        return (d1[None], c1[None], d2[None], c2[None], nrm[None],
                ovf[None])

    g = a.get_grid()
    want = _jax_run(fn, [g.points.numpy(), g.bbox_lo.numpy(),
                         g.bbox_hi.numpy(), plane.points.numpy()], 5, 1)
    return a, plane, want


def test_ring_knn_coords_match_jax(knn_case):
    """The brute and the pruned ring k-NN give JAX's coordinates (ties to
    the earlier candidate on both sides) and its distances within one
    rounding (XLA:CPU adds the squares in another order or contracts them
    into FMAs), and agree with each other on the valid rows' distances."""
    a, _, (jd1, jc1, jd2, jc2, _, jovf) = knn_case
    g = a.get_grid()
    row = _row()
    pts = _slots(g.points, row)
    d1, c1 = ring_knn_coords(pts, pts, k=12)
    d2, c2, ovf = ring_knn_coords_pruned(
        pts, pts, _slots(g.bbox_lo, row), _slots(g.bbox_hi, row), a.n, k=12,
        cap=8)
    assert not any(bool(o) for o in ovf) and not jovf
    for got, want in ((d1, jd1), (d2, jd2)):
        np.testing.assert_allclose(_cat(got), want, rtol=BRUTE_D_RTOL, atol=0)
    for got, want in ((c1, jc1), (c2, jc2)):
        np.testing.assert_array_equal(_cat(got), want)
    np.testing.assert_array_equal(_cat(d1)[:a.n], _cat(d2)[:a.n])


def test_ring_normals_match_single_device_and_jax(knn_case):
    """PCA normals of a plane through the ring are its normal (|dot| within
    1e-5 of 1, the JAX test's bar) and JAX's (|dot| within 1e-9)."""
    _, plane, (_, _, _, _, jnrm, _) = knn_case
    nrm = _cat(ring_normals(_slots(plane.points, _row())))[:900]
    np.testing.assert_allclose(np.abs(nrm @ [0.0, 0.0, 1.0]), 1.0, atol=1e-5)
    dots = np.abs(np.sum(nrm * jnrm[:900], axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-9)


# ------------------------------------------------------- the sharded stats


def _sphere_frames(seed, sizes, p, scale, dtype, noise="int", colors=True,
                   normals=True):
    """Frames of a sphere shell and its perturbed copy, as port Clouds."""
    rng = np.random.default_rng(seed)
    frames = []
    for n in sizes:
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        if noise == "int":
            pts0 = np.round(v * scale)
            pts1 = pts0 + rng.integers(-1, 2, pts0.shape)
        else:
            pts0 = v * scale
            pts1 = pts0 + rng.normal(scale=0.2, size=pts0.shape)
        c0, c1 = rng.uniform(0, 1, pts0.shape), rng.uniform(0, 1, pts1.shape)
        n1 = pts1 / np.maximum(np.linalg.norm(pts1, axis=1, keepdims=True),
                               1e-9)
        frames.append((
            _cloud(pts0, p, dtype, colors=c0 if colors else None,
                   normals=v if normals else None),
            _cloud(pts1, p, dtype, colors=c1 if colors else None,
                   normals=n1 if normals else None)))
    return frames


def _assert_frame(stats, f, single, rtol, atol=0.0):
    for key, val in single.items():
        if key == "nn_overflow":
            continue
        np.testing.assert_allclose(
            stats[key][f].numpy(), np.asarray(val), rtol=rtol, atol=atol,
            err_msg=key)


def _stack(frames, attr, side):
    return torch.stack([getattr(fr[side], attr) for fr in frames])


def _brute_args(frames):
    return (_stack(frames, "points", 0), _stack(frames, "points", 1),
            [fr[0].n for fr in frames], [fr[1].n for fr in frames])


@pytest.mark.parametrize("dp,scheme,p2p", [(2, "ycc", False), (1, None, True)])
def test_sharded_full_step_matches_single_device(dp, scheme, p2p):
    """The brute ring's stats (8 slots) equal the port's single-device
    pair_stats within 1e-10 relative in float64."""
    frames = _sphere_frames(3, (700, 750), 1024, 60.0, torch.float64,
                            noise="normal")
    kw = {}
    if scheme:
        kw.update(a_col=_stack(frames, "colors", 0),
                  b_col=_stack(frames, "colors", 1))
    if p2p:
        kw.update(a_nrm=_stack(frames, "normals", 0),
                  b_nrm=_stack(frames, "normals", 1))
    stats = sharded_pair_stats(make_mesh(devices=CPU8, dp=dp),
                               *_brute_args(frames), color_scheme=scheme,
                               point_to_plane=p2p, **kw)
    for f, (a, b) in enumerate(frames):
        single = pair_stats(
            a.points, b.points, a.n, b.n,
            a_col=a.colors if scheme else None,
            b_col=b.colors if scheme else None,
            a_nrm=a.normals if p2p else None,
            b_nrm=b.normals if p2p else None,
            color_scheme=scheme, point_to_plane=p2p, backend="brute")
        _assert_frame(stats, f, single, F64_RTOL)


def test_sharded_stats_match_jax():
    """The brute and the pruned ring's stats (colour, point-to-plane in
    pc_error mode) against JAX's sharded_pair_stats and
    sharded_pair_stats_pruned on the same (2, 4) mesh shape: float64 brute
    within 1e-10 relative, float32 pruned within 1e-5 / 1e-7."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.cloud import Cloud as JCloud
    from open_pcc_metric_tpu.parallel import make_mesh as jmesh
    from open_pcc_metric_tpu.parallel import sharded_pair_stats as jbrute
    from open_pcc_metric_tpu.parallel.sharded import (
        pack_sorted_frames as jpack, sharded_pair_stats_pruned as jpruned)

    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    frames = _sphere_frames(3, (700, 750), 1024, 60.0, torch.float64,
                            noise="normal")
    args = _brute_args(frames)
    cols = dict(a_col=_stack(frames, "colors", 0),
                b_col=_stack(frames, "colors", 1),
                a_nrm=_stack(frames, "normals", 0),
                b_nrm=_stack(frames, "normals", 1))
    got = sharded_pair_stats(make_mesh(devices=CPU8, dp=2), *args, **cols,
                             **kw)
    want = jbrute(jmesh(8, dp=2), *[jnp.asarray(np.asarray(x))
                                    for x in args],
                  **{k: jnp.asarray(v.numpy()) for k, v in cols.items()},
                  **kw)
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(val),
                                   rtol=F64_RTOL, err_msg=key)

    frames = _sphere_frames(13, (1500, 1600), 2048, 200.0, torch.float32)
    jframes = [[JCloud.from_numpy(c.host_points, colors=c.colors.numpy()[:c.n],
                                  normals=c.normals.numpy()[:c.n],
                                  dtype=jnp.float32, pad_to=2048)
                for c in fr] for fr in frames]
    got = sharded_pair_stats_pruned(
        make_mesh(devices=CPU8, dp=2),
        pack_sorted_frames(*zip(*frames), **kw), **kw)
    want = jpruned(jmesh(8, dp=2), jpack(*zip(*jframes), **kw), **kw)
    assert not got["nn_overflow"].any() and not np.asarray(
        want["nn_overflow"]).any()
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(val),
                                   rtol=F32_RTOL, atol=F32_ATOL, err_msg=key)


@pytest.mark.parametrize("scheme,d2", [("ycc", "pc_error"),
                                       (None, "reference")])
def test_sharded_pruned_matches_single_device(scheme, d2):
    """The pruned ring over sorted shards (mesh (2, 4)), with and without the
    ladder, equals the port's single-device pair_stats within 1e-5 / 1e-7
    in float32."""
    frames = _sphere_frames(13, (1500, 1600), 2048, 200.0, torch.float32)
    kw = dict(color_scheme=scheme, point_to_plane=True, d2_mode=d2)
    mesh = make_mesh(devices=CPU8, dp=2)
    packed = pack_sorted_frames(*zip(*frames), **kw)
    stats = sharded_pair_stats_pruned(mesh, packed, **kw)
    auto = sharded_pair_stats_pruned_auto(mesh, packed, **kw)
    assert not stats["nn_overflow"].any()
    for f, (a, b) in enumerate(frames):
        single = pair_stats(
            a.points, b.points, a.n, b.n,
            a_col=a.colors if scheme else None,
            b_col=b.colors if scheme else None,
            a_nrm=a.normals, b_nrm=b.normals, backend="pruned", **kw)
        _assert_frame(stats, f, single, F32_RTOL, F32_ATOL)
        _assert_frame(auto, f, single, F32_RTOL, F32_ATOL)


def test_finalize_matches_oracle_through_sharded_path():
    import oracle

    rng = np.random.default_rng(4)
    pts0 = rng.uniform(0, 100, (800, 3))
    pts1 = rng.uniform(0, 100, (750, 3))
    a, b = _cloud(pts0, 1024), _cloud(pts1, 1024)
    stats = sharded_pair_stats(make_mesh(devices=CPU8), a.points[None],
                               b.points[None], [800], [750])
    peak = float(np.max(oracle.minimal_obb_extent(pts0)))
    final = finalize_stats({k: v[0] for k, v in stats.items()}, peak)
    ref = oracle.full_metrics(pts0, pts1, hausdorff=True)
    for key in ("geo_mse_left", "geo_mse_right", "geo_psnr_sym",
                "min_sqrt", "max_sqrt", "geo_hausdorff_sym"):
        np.testing.assert_allclose(final[key], ref[key], rtol=1e-9,
                                   err_msg=key)


@pytest.mark.parametrize("d2", ["reference", "pc_error"])
def test_sharded_pruned_estimates_missing_normals(d2):
    """Point-to-plane on clouds without file normals packs each Cloud's
    single-device estimate, in both D2 modes."""
    frames = _sphere_frames(21, (1200, 1280), 2048, 150.0, torch.float32,
                            colors=False, normals=False)
    kw = dict(point_to_plane=True, d2_mode=d2)
    mesh = make_mesh(devices=CPU8, dp=2)
    stats = sharded_pair_stats_pruned(
        mesh, pack_sorted_frames(*zip(*frames), **kw), **kw)
    assert not stats["nn_overflow"].any()
    for f, (a, b) in enumerate(frames):
        single = pair_stats(a.points, b.points, a.n, b.n,
                            a_nrm=a.get_normals(), b_nrm=b.get_normals(),
                            backend="pruned", **kw)
        _assert_frame(stats, f, single, F32_RTOL, F32_ATOL)


def test_sharded_pruned_mixed_normals_group():
    """A group mixing frames with and without file normals stays
    frame-aligned: file normals where present, estimates elsewhere."""
    with_nrm = _sphere_frames(22, (1100,), 2048, 140.0, torch.float32,
                              colors=False)
    without = _sphere_frames(23, (1100,), 2048, 140.0, torch.float32,
                             colors=False, normals=False)
    frames = with_nrm + without
    kw = dict(point_to_plane=True, d2_mode="reference")
    stats = sharded_pair_stats_pruned(
        make_mesh(devices=CPU8, dp=2),
        pack_sorted_frames(*zip(*frames), **kw), **kw)
    assert not stats["nn_overflow"].any()
    for f, (a, b) in enumerate(frames):
        single = pair_stats(a.points, b.points, a.n, b.n,
                            a_nrm=a.get_normals(), b_nrm=b.get_normals(),
                            backend="pruned", **kw)
        _assert_frame(stats, f, single, F32_RTOL, F32_ATOL)


def test_sharded_pruned_in_mesh_estimation():
    """pc_error with a_nrm_s/b_nrm_s dropped from the packed dict estimates
    the normals in the mesh (ring_normals_pruned): D1 and colour stats as
    before, and D2 within 5% of the single-device estimate's (voxel grids
    have k-NN ties, which the two exact searches break apart)."""
    frames = _sphere_frames(24, (1300,), 2048, 150.0, torch.float32,
                            normals=False)
    kw = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    packed = dict(pack_sorted_frames(*zip(*frames), **kw))
    packed["a_nrm_s"] = packed["b_nrm_s"] = None
    stats = sharded_pair_stats_pruned(make_mesh(devices=CPU8), packed, **kw)
    assert not stats["nn_overflow"].any()
    a, b = frames[0]
    single = pair_stats(a.points, b.points, a.n, b.n, a_col=a.colors,
                        b_col=b.colors, a_nrm=a.get_normals(),
                        b_nrm=b.get_normals(), backend="pruned", **kw)
    _assert_frame(stats, 0, {k: v for k, v in single.items()
                             if not k.startswith("d2_")}, F32_RTOL, F32_ATOL)
    _assert_frame(stats, 0, {k: v for k, v in single.items()
                             if k.startswith("d2_sse")}, 0.05)


def test_reference_mode_errors():
    """Reference-mode D2 raises IndexError when a frame has n_a > n_b (both
    rings), and ValueError on sorted shards without the pre-gathered
    positional normals."""
    rng = np.random.default_rng(23)
    pts0 = np.round(rng.uniform(0, 100, (900, 3)))
    a = [_cloud(pts0, 2048, torch.float32)]
    b = [_cloud(pts0 + 0.5, 2048, torch.float32)]
    mesh = make_mesh(devices=CPU8)
    kw = dict(point_to_plane=True, d2_mode="reference")
    packed = dict(pack_sorted_frames(a, b, **kw))
    packed["nrm_for_a"] = packed["nrm_for_b"] = None
    with pytest.raises(ValueError, match="positional normals"):
        sharded_pair_stats_pruned(mesh, packed, **kw)
    small = [_cloud(pts0[:500], 2048, torch.float32)]
    with pytest.raises(IndexError, match="n_origin <= n_reconst"):
        sharded_pair_stats_pruned(
            mesh, pack_sorted_frames(a, small, **kw), **kw)
    nrm = torch.zeros((1, 2048, 3))
    with pytest.raises(IndexError, match="n_origin <= n_reconst"):
        sharded_pair_stats(mesh, a[0].points[None], small[0].points[None],
                           [900], [500], a_nrm=nrm, b_nrm=nrm, **kw)


def _plain_payload(pay_cur, perm_cur, ids):
    """Each id's payload row: the row of ``pay_cur`` whose original id
    (``perm_cur``) it is, found by a sorted search."""
    order = torch.argsort(perm_cur.long())
    pos = torch.searchsorted(perm_cur.long()[order], ids.long())
    return pay_cur[order[pos.clamp(max=order.numel() - 1)]]


@pytest.mark.cuda
def test_four_slot_ring_k1_on_card_matches_plain(monkeypatch):
    """On one card, a 4-slot ring over cuda:0 (the counterpart of four
    devices) launches K1 in every step, and each launch equals the plain
    version (``refine_nn_reference``) on the same inputs bit for bit on
    every valid query row: d, original ids and payload rows. At cap 16,
    below a slot's chunk count, step 0's extension and the rotations run
    partial, count-gated tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(31)
    v = rng.normal(size=(100_000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = np.unique(np.round(v * 200.0 + 512.0), axis=0)
    a = Cloud.from_numpy(pts, pad_to=-(-len(pts) // 1024) * 1024,
                         device=dev)
    row = [dev] * 4
    qa, pb, perm, lo, hi, pay = _pruned_inputs(a, a)
    a_slots = _slots(qa, row)
    calls = []
    real = sharded._refine_local_pallas

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(sharded, "_refine_local_pallas", spy)
    refine.refine_nn.launches = 0
    sharded.ring_nn_pruned(a_slots, _slots(pb, row), _slots(perm, row),
                           _slots(lo, row), _slots(hi, row), a.n, a.n,
                           payload=_slots(pay, row), exclude_self=True,
                           cap=16)
    assert refine.refine_nn.launches == len(calls) == 4 * (2 + 3)
    pl_rows = a_slots[0].shape[0]
    partial = 0
    for (q, b_cur, perm_cur, pay_cur, cand, ncand, nsh, excl), got in calls:
        me = next(j for j, x in enumerate(a_slots) if x is q)
        valid = me * pl_rows + torch.arange(pl_rows, device=dev) < a.n
        d, ii = refine.refine_nn_reference(q, b_cur, perm_cur,
                                           cand.contiguous(), ncand=ncand,
                                           exclude_self=excl)
        d, ii = d.reshape(-1), ii.reshape(-1)
        assert torch.equal(got[0][valid], d[valid])
        assert torch.equal(got[1][valid], ii[valid])
        won = valid & (ii != refine.INT_MAX)
        assert torch.equal(got[2][won],
                           _plain_payload(pay_cur, perm_cur, ii)[won])
        if ncand is not None:
            partial += int(((ncand > 0) & (ncand < cand.shape[1])).any())
    assert partial >= 4  # every slot's extension at least
