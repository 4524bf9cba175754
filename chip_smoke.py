#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (open_pcc_metric_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``open_pcc_metric_tpu_torch/csrc``
(one nvcc per source, all started together), checks each against its plain
PyTorch version at the shapes the evaluation paths give it, and drives two
paths on bench.py's 800k-point voxelised pair (ycc + point-to-plane +
pc_error + Hausdorff):

  * the main path: ``fused_evaluate`` on clouds that carry normals (K1),
    with the three NN sweeps checked against an exact float64 scipy oracle
    and the PSNRs against a float64 numpy evaluation;
  * the estimation path: the same pair without normals, fresh clouds per
    run, so each run estimates 30-NN PCA normals (K3, K4) before the
    sweeps (K1); the k-NN sets are checked against an exact float64 scipy
    oracle, the normals against float64 LAPACK normals of those sets, and
    the PSNRs against a float64 evaluation with those normals.

It prints:

  * the card's name and power limit (nvidia-smi),
  * each kernel's build time and ptxas resource lines,
  * one line per kernel phase, one timing line per path,
  * a ``{"kernels": [...]}`` JSON line, and last
  * ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed check raises, so the exit code is non-zero and the last line is
never printed. Without a CUDA device it exits non-zero before printing any
result. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_POINTS = 800_000
RUNS = 5
EST_RUNS = 3
CAP, FALLBACK, P1 = 32, 256, 8  # the main path's base rung and probe width
K, KCAP, KFT = 30, 64, 256  # the estimation's k and base rung
PLAIN_BUDGET_S = 60.0  # a plain phase predicted slower runs on a subset
MOM_RTOL, MOM_ATOL = 1e-6, 1e-4  # K4 vs plain: float32 summation order
D2_TOL, PSNR_TOL = 5e-3, 1e-4  # dB; D2 with estimated normals, the rest
KERNELS = {
    "refine_nn": "open_pcc_metric_tpu/ops/refine_pallas.py:575",
    "refine_knn": "open_pcc_metric_tpu/ops/refine_pallas.py:861",
    "knn_moments": "open_pcc_metric_tpu/ops/refine_pallas.py:1330",
}


def _bit_equal(x, y) -> bool:
    import torch

    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return bool(torch.equal(x, y))


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _once_ms(fn):
    """(result, device ms) of one call, synchronised."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _counts_of(dist, lb, valid_t):
    """Certificate counts: chunks with lb <= the tile's padded ub, where ub
    is the largest ``dist`` over the tile's valid rows."""
    import torch

    eps = torch.finfo(torch.float32).eps
    ub = torch.where(valid_t, dist, -torch.inf).amax(dim=1)
    ub_eff = ub * (1 + 8 * eps) + 8 * eps
    return (lb <= ub_eff[:, None]).sum(dim=1, dtype=torch.int32)


def kernel_phases(a, b, float_cloud):
    """K1 against refine_nn_reference on the card, at main-path shapes.

    Returns one record per phase: the call's shape, the largest |d| error
    (0 when bit-identical, which is required), and both times.
    """
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import stable_top, tile_bounds
    from open_pcc_metric_tpu_torch.ops.refine import (
        refine_nn, refine_nn_reference)

    def check(name, qg, bg, cand, **kw):
        args = (qg.points, bg.points, bg.perm, cand.contiguous())
        dk, ik = refine_nn(*args, **kw)
        torch.cuda.synchronize()
        dr, ir = refine_nn_reference(*args, **kw)
        torch.cuda.synchronize()
        finite = torch.isfinite(dr)
        err = float(torch.where(finite, (dk - dr).abs(), 0).max())
        if not (_bit_equal(dk, dr) and _bit_equal(ik, ir)):
            bad = int(((dk != dr) | (ik != ir)).sum())
            raise AssertionError(
                f"K1 phase {name}: {bad} rows differ from refine_nn_reference "
                f"(max |d| error {err})")
        rec = {
            "phase": name, "tiles": int(cand.shape[0]),
            "slots": int(cand.shape[1]), "max_abs_err": err,
            "ms": _time_ms(lambda: refine_nn(*args, **kw), 20),
            "plain_ms": _time_ms(lambda: refine_nn_reference(*args, **kw), 3),
        }
        print("kernel phase " + json.dumps(rec), flush=True)
        return dk, ik, rec

    records = []
    ga, gb = a.get_grid(), b.get_grid()
    valid_t, lb, order = tile_bounds(ga, gb, a.n)
    # Probe: the p1 lowest-lb chunks of every tile.
    d1, i1, rec = check("probe a->b", ga, gb, order[:, :P1])
    records.append(rec)
    # Gated, seeded in-place extension to min(count, cap).
    ncand2 = torch.clamp(_counts_of(d1, lb, valid_t) - P1, 0, CAP - P1).int()
    d2, i2, rec = check("extension a->b", ga, gb, order[:, P1:CAP],
                        ncand=ncand2, init=(d1, i1))
    records.append(rec)
    # Compacted tier-A tiles, read in place through global tile ids.
    counts = _counts_of(d2, lb, valid_t)
    otiles = stable_top(counts, FALLBACK)
    cap2a = min(4 * CAP, gb.n_chunks)
    oc = counts[otiles]
    ncand_a = torch.where(oc > CAP, torch.clamp(oc, max=cap2a) - CAP, 0).int()
    init_a = (d2[otiles].contiguous(), i2[otiles].contiguous())
    records.append(check("tier A a->b (gated)", ga, gb, order[otiles, CAP:cap2a],
                         tiles=otiles.int(), ncand=ncand_a, init=init_a)[2])
    records.append(check("tier A a->b (all slots)", ga, gb,
                         order[otiles, CAP:cap2a], tiles=otiles.int(),
                         init=init_a)[2])
    # Self search: exclude_self on the full probe and on compacted tiles
    # whose candidate rows include the tile's own chunk.
    order_s = tile_bounds(ga, ga, a.n)[2]
    records.append(check("self probe a->a", ga, ga, order_s[:, :P1],
                         exclude_self=True)[2])
    records.append(check("self tier a->a (compacted)", ga, ga,
                         order_s[otiles, :cap2a - CAP], tiles=otiles.int(),
                         exclude_self=True)[2])
    # A float cloud: every distance is a rounded float, not an integer.
    gf = float_cloud.get_grid()
    valid_f, lb_f, order_f = tile_bounds(gf, gb, float_cloud.n)
    df, i_f, rec = check("float probe", gf, gb, order_f[:, :P1])
    records.append(rec)
    ncand_f = torch.clamp(_counts_of(df, lb_f, valid_f) - P1, 0, CAP - P1).int()
    records.append(check("float extension", gf, gb, order_f[:, P1:CAP],
                         ncand=ncand_f, init=(df, i_f))[2])
    return records


def knn_phases(a, float_cloud):
    """K3 and K4 against their plain versions on the card, at the shapes the
    estimation of cloud ``a`` gives them (self 30-NN, cap 64, fallback 256,
    p1 8): the probe, the gated seeded extension, tier A on compacted
    tiles, K4 stage 1, a K4 tier, and one float-cloud probe.

    K3 must be bit-identical in d and id. K4 must count the same members
    (exactly k on every valid row once the tier has run) and agree on the
    other sums within MOM_RTOL/MOM_ATOL. A plain call predicted to pass
    PLAIN_BUDGET_S runs on a stated subset of tiles that holds the 64
    with the most live slots. Returns (K3 records, K4 records).
    """
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import stable_top, tile_bounds
    from open_pcc_metric_tpu_torch.ops.refine import (
        knn_moments, knn_moments_reference, refine_knn, refine_knn_reference)

    dev = a.points.device

    def subset(live, nt, n_sub):
        """At least n_sub tile rows: the 64 with the most live slots and
        n_sub evenly spaced ones (all rows when nt <= n_sub)."""
        if nt <= n_sub:
            return torch.arange(nt, device=dev)
        keep = torch.zeros(nt, dtype=torch.bool, device=dev)
        keep[stable_top(live, 64)] = True
        keep[torch.linspace(0, nt - 1, n_sub, device=dev).long()] = True
        return keep.nonzero()[:, 0]

    def run(name, kernel, plain, compare, cand, ncand=None, tiles=None,
            init=None, **kw):
        """Kernel on the full call, plain on the full call or a subset."""
        nt = cand.shape[0]
        args = dict(kw, tiles=tiles, init=init)
        if ncand is not None:
            args["ncand"] = ncand
        out = kernel(cand=cand, **args)
        torch.cuda.synchronize()
        rows = torch.arange(nt, device=dev)
        live = ncand if ncand is not None else torch.full(
            (nt,), cand.shape[1], dtype=torch.int32, device=dev)
        sub_rows = subset(live, nt, 512)
        sub, sub_ms = _once_ms(lambda: plain(cand=cand[sub_rows].contiguous(),
                                             **_rows_of(args, sub_rows)))
        predicted_s = sub_ms / len(sub_rows) * nt / 1e3
        note = None
        if len(sub_rows) == nt:
            want, plain_ms = sub, sub_ms
        elif predicted_s > PLAIN_BUDGET_S:
            rows, want, plain_ms = sub_rows, sub, None
            note = (f"plain version compared on {len(rows)} of {nt} tiles "
                    "(the 64 with the most live slots and 512 evenly "
                    f"spaced): the full call was predicted to take "
                    f"{predicted_s:.0f} s")
        else:
            want, plain_ms = _once_ms(lambda: plain(cand=cand, **args))
        got = tuple(x[rows] for x in out) if isinstance(out, tuple) else out[rows]
        err = compare(name, got, want)
        rec = {
            "phase": name, "tiles": int(nt), "slots": int(cand.shape[1]),
            "max_abs_err": err,
            "ms": _time_ms(lambda: kernel(cand=cand, **args), 5),
            "plain_ms": plain_ms,
        }
        if note:
            rec["plain_subset"] = note
            rec["plain_subset_ms"] = sub_ms
        print("kernel phase " + json.dumps(rec), flush=True)
        return out, rec

    def knn_compare(name, got, want):
        if not (_bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1])):
            bad = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
            raise AssertionError(
                f"K3 phase {name}: {bad} entries differ from "
                "refine_knn_reference")
        return 0.0

    def mom_compare(name, got, want):
        if not torch.equal(got[..., 0], want[..., 0]):
            bad = int((got[..., 0] != want[..., 0]).sum())
            raise AssertionError(f"K4 phase {name}: {bad} member counts "
                                 "differ from knn_moments_reference")
        err = (got - want).abs()
        bound = MOM_ATOL + MOM_RTOL * want.abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"K4 phase {name}: sums off by up to "
                                 f"{float(err.max())}")
        return float(err.max())

    g = a.get_grid()
    valid_t, lb, order = tile_bounds(g, g, a.n)
    ncb = g.n_chunks

    def k3(cand, **kw):
        return refine_knn(g.points, g.points, g.perm, cand.contiguous(), K, **kw)

    def k3_plain(cand, **kw):
        return refine_knn_reference(g.points, g.points, g.perm,
                                    cand.contiguous(), K, **kw)

    def k4(cand, **kw):
        return knn_moments(g.points, g.points, g.perm, cand.contiguous(), **kw)

    def k4_plain(cand, **kw):
        return knn_moments_reference(g.points, g.points, g.perm,
                                     cand.contiguous(), **kw)

    k3_recs, k4_recs = [], []
    (d1, i1), rec = run("knn probe a->a", k3, k3_plain, knn_compare,
                        order[:, :P1])
    k3_recs.append(rec)
    counts1 = _counts_of(d1[:, :, -1], lb, valid_t)
    ncand2 = torch.clamp(counts1 - P1, 0, KCAP - P1).int()
    (dk, ik), rec = run("knn extension a->a (gated, seeded)", k3, k3_plain,
                        knn_compare, order[:, P1:KCAP], ncand=ncand2,
                        init=(d1, i1))
    k3_recs.append(rec)
    counts = _counts_of(dk[:, :, -1], lb, valid_t)
    otiles = stable_top(counts, KFT)
    cap2a = min(max(2 * KCAP, 128), ncb)
    oc = counts[otiles]
    ncand_a = torch.where(oc > KCAP, torch.clamp(oc, max=cap2a) - KCAP, 0).int()
    (fd, fi), rec = run("knn tier A a->a (compacted)", k3, k3_plain,
                        knn_compare, order[otiles, KCAP:cap2a],
                        ncand=ncand_a, tiles=otiles.int(),
                        init=(dk[otiles].contiguous(), ik[otiles].contiguous()))
    k3_recs.append(rec)
    dk = dk.index_copy(0, otiles, fd)
    ik = ik.index_copy(0, otiles, fi)

    rk, rid = dk[:, :, -1].contiguous(), ik[:, :, -1].contiguous()
    countsf = _counts_of(rk, lb, valid_t)
    mom, rec = run("moments stage 1 a->a", k4, k4_plain, mom_compare,
                   order[:, :KCAP], ncand=torch.clamp(countsf, max=KCAP).int(),
                   rk=rk, ik=rid)
    k4_recs.append(rec)
    cf = countsf[otiles]
    ncm = torch.where(cf > KCAP, torch.clamp(cf, max=cap2a) - KCAP, 0).int()
    part, rec = run("moments tier A a->a (compacted)", k4, k4_plain,
                    mom_compare, order[otiles, KCAP:cap2a], ncand=ncm,
                    tiles=otiles.int(), rk=rk[otiles].contiguous(),
                    ik=rid[otiles].contiguous(), init=mom[otiles].contiguous())
    k4_recs.append(rec)
    mom = mom.index_copy(0, otiles, part)
    # Every valid row whose tile the two passes cover counts exactly k.
    in_tier = torch.zeros_like(countsf, dtype=torch.bool)
    in_tier[otiles] = True
    covered = ((countsf <= KCAP) | (in_tier & (countsf <= cap2a)))[:, None] \
        & valid_t
    uncovered = int((valid_t & ~covered).sum())
    cnt = mom[..., 0][covered]
    if not bool((cnt == K).all()):
        raise AssertionError(f"K4: {int((cnt != K).sum())} valid rows do not "
                             f"count exactly {K} members")
    print(f"moments: {int(covered.sum())} valid rows count exactly {K} "
          f"members ({uncovered} rows left to tier B)", flush=True)

    gf = float_cloud.get_grid()
    order_f = tile_bounds(gf, gf, float_cloud.n)[2]

    def k3f(cand, **kw):
        return refine_knn(gf.points, gf.points, gf.perm, cand.contiguous(), K,
                          **kw)

    def k3f_plain(cand, **kw):
        return refine_knn_reference(gf.points, gf.points, gf.perm,
                                    cand.contiguous(), K, **kw)

    k3_recs.append(run("knn float probe", k3f, k3f_plain, knn_compare,
                       order_f[:, :P1])[1])
    return k3_recs, k4_recs


def _rows_of(args, rows):
    """The per-tile arguments of a refine call restricted to the tile rows
    ``rows``, which keep reading their own queries through global ids."""
    import torch

    out = {}
    for key, val in args.items():
        if isinstance(val, tuple):
            out[key] = tuple(x[rows].contiguous() for x in val)
        elif isinstance(val, torch.Tensor):
            out[key] = val[rows].contiguous()
        else:
            out[key] = val
    if args.get("tiles") is None:
        out["tiles"] = rows.to(torch.int32)
    return out


def _full_phase(records):
    """The first phase whose plain version ran on the full call."""
    return next(r for r in records if r["plain_ms"] is not None)


def _guarded(modules_names):
    """Replace plain versions by guards that raise on a CUDA tensor;
    returns a function that restores them."""
    saved = []
    for mod, name in modules_names:
        plain = getattr(mod, name)

        def guard(q_sorted, *args, _plain=plain, _name=name, **kw):
            if q_sorted.is_cuda:
                raise AssertionError(f"a CUDA tensor reached {_name}")
            return _plain(q_sorted, *args, **kw)

        saved.append((mod, name, plain))
        setattr(mod, name, guard)

    def restore():
        for mod, name, plain in saved:
            setattr(mod, name, plain)

    return restore


def _plain_names():
    from open_pcc_metric_tpu_torch.ops import refine

    return [(refine, "refine_nn_reference"), (refine, "refine_knn_reference"),
            (refine, "knn_moments_reference")]


def _reset_launches():
    from open_pcc_metric_tpu_torch.ops import refine

    for name in KERNELS:
        getattr(refine, name).launches = 0


def _launches():
    from open_pcc_metric_tpu_torch.ops import refine

    return {name: getattr(refine, name).launches for name in KERNELS}


def main_path(origin, reconst, dev):
    """fused_evaluate on the card: one warm-up, then the median of RUNS."""
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    a = Cloud.from_numpy(origin[0], colors=origin[1], normals=origin[2],
                         device=dev)
    b = Cloud.from_numpy(reconst[0], colors=reconst[1], normals=reconst[2],
                         device=dev)
    torch.cuda.synchronize()
    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    restore = _guarded(_plain_names())
    try:
        _reset_launches()
        t0 = time.perf_counter()
        result = fused_evaluate(a, b, **kwargs)  # builds grids, caches, self-NN
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            result = fused_evaluate(a, b, **kwargs)  # ends in a host readback
            times.append(time.perf_counter() - t0)
        launches = _launches()
    finally:
        restore()
    if launches["refine_nn"] <= 0:
        raise AssertionError("the main path launched K1 no time")
    return a, b, result, first_s, times, launches


def estimation_path(origin, reconst, dev):
    """fused_evaluate on the pair without normals, fresh clouds per run
    (cold, like bench.py's PCC_BENCH_NORMALS=1): one warm-up, then the
    median of EST_RUNS. Returns the last run's clouds and result."""
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    def make():
        a = Cloud.from_numpy(origin[0], colors=origin[1], device=dev)
        b = Cloud.from_numpy(reconst[0], colors=reconst[1], device=dev)
        torch.cuda.synchronize()
        return a, b

    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    restore = _guarded(_plain_names())
    try:
        _reset_launches()
        a, b = make()
        t0 = time.perf_counter()
        result = fused_evaluate(a, b, **kwargs)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(EST_RUNS):
            a, b = make()
            t0 = time.perf_counter()
            result = fused_evaluate(a, b, **kwargs)
            times.append(time.perf_counter() - t0)
        launches = _launches()
    finally:
        restore()
    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"the estimation path launched {name} no time")
    return a, b, result, first_s, times, launches


def _want_psnrs(origin, reconst, sweeps, nrm0, nrm1):
    """float64 PSNRs of the suite from oracle NN sweeps and given normals."""
    from open_pcc_metric_tpu_torch.ops.obb import minimal_obb_extent

    pts0, col0 = origin[0], origin[1]
    pts1, col1 = reconst[0], reconst[1]
    (i0, d0), (i1, d1), (_, ds) = (sweeps["a->b"], sweeps["b->a"],
                                   sweeps["self a->a"])
    m = np.array([[0.2126, 0.7152, 0.0722],
                  [-0.1146, -0.3854, 0.5],
                  [0.5, -0.4542, -0.0458]])
    peak = minimal_obb_extent(pts0).max()
    hpeak2 = np.sqrt(ds).max() ** 2
    p0 = ((pts0 - pts1[i0]) * nrm1[i0]).sum(1) ** 2
    p1 = ((pts1 - pts0[i1]) * nrm0[i1]).sum(1) ** 2
    c0 = ((col0 - col1[i0]) @ m.T) ** 2
    c1 = ((col1 - col0[i1]) @ m.T) ** 2
    want = {}
    for side, dd, pp, cc in (("left", d0, p0, c0), ("right", d1, p1, c1)):
        want[f"geo_psnr_{side}"] = 10 * np.log10(peak**2 / dd.mean())
        want[f"geo_hausdorff_psnr_{side}"] = 10 * np.log10(hpeak2 / dd.max())
        want[f"d2_psnr_{side}"] = 10 * np.log10(peak**2 / pp.mean())
        want[f"d2_hausdorff_psnr_{side}"] = 10 * np.log10(hpeak2 / pp.max())
        want[f"color_psnr_{side}"] = 10 * np.log10(1.0 / cc.mean(0))
    return want


def _psnr_deltas(result, want):
    return {k: float(np.max(np.abs(np.asarray(result[k], np.float64) - v)))
            for k, v in want.items()}


def oracle_checks(a, b, origin, reconst, result):
    """The three NN sweeps bit-exact vs the scipy float64 oracle, and the
    PSNRs vs a float64 numpy evaluation built from the oracle neighbours.
    Returns the oracle sweeps."""
    import bench
    from open_pcc_metric_tpu_torch.ops.fused import _LADDER_MEMO
    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        nn_pruned_sorted, unsort_nn_result)

    pts0, pts1 = origin[0], reconst[0]
    rungs = {rung for rung, _ in _LADDER_MEMO.values()}
    cap, ft = rungs.pop() if len(rungs) == 1 else (CAP, FALLBACK)
    sweeps = {}
    for name, q, s, ex in (("a->b", a, b, False), ("b->a", b, a, False),
                           ("self a->a", a, a, True)):
        gq, gs = q.get_grid(), s.get_grid()
        d_s, i_s, ov = nn_pruned_sorted(gq, gs, q.n, exclude_self=ex,
                                        cap=cap, fallback_tiles=ft)
        if bool(ov):
            raise AssertionError(f"sweep {name} overflowed at rung {(cap, ft)}")
        d, i = unsort_nn_result(gq, gs, d_s, i_s)
        d = d[: q.n].double().cpu().numpy()
        i = i[: q.n].cpu().numpy()
        qp = pts0 if q is a else pts1
        sp = pts0 if s is a else pts1
        oi, od = bench._oracle_nn_fast(qp, sp, exclude_self=ex)
        bad = int(np.sum((oi != i) | (od != d)))
        print(f"sweep {name}: {q.n} queries, {bad} differ from the oracle",
              flush=True)
        if bad:
            raise AssertionError(f"sweep {name}: {bad} rows differ from the "
                                 "float64 oracle")
        sweeps[name] = (oi, od)

    want = _want_psnrs(origin, reconst, sweeps, origin[2], reconst[2])
    delta = max(_psnr_deltas(result, want).values())
    print(f"max |dPSNR| vs float64 oracle evaluation: {delta:.3e} dB "
          f"({len(want)} PSNR entries)", flush=True)
    if not delta <= PSNR_TOL:
        raise AssertionError(f"PSNR parity: max |delta| {delta:.3e} > 1e-4 dB")
    return sweeps


def estimation_checks(a, b, origin, reconst, result, sweeps):
    """The port's 30-NN sets of both clouds against the exact float64
    scipy oracle (0 rows may differ), its normals against float64 LAPACK
    normals of those sets (0.001-quantile of |dot| above 0.999), and the
    PSNRs against a float64 evaluation with those normals: D2 entries
    within D2_TOL, the others within PSNR_TOL. Returns the numbers."""
    import bench
    from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned

    lapack = {}
    out = {}
    for name, c, pts in (("origin", a, origin[0]), ("reconst", b, reconst[0])):
        oi, _ = bench._oracle_knn_fast(pts, pts, K)
        idx, _ = knn_pruned(c.points, c.points, c.n, c.n, k=K,
                            cap=KCAP, fallback_tiles=KFT)
        bad = int(np.any(idx[: c.n].cpu().numpy() != oi, axis=1).sum())
        neigh = pts[oi]
        cen = neigh - neigh.mean(axis=1, keepdims=True)
        cov = np.einsum("nki,nkj->nij", cen, cen) / K
        lapack[name] = np.linalg.eigh(cov)[1][:, :, 0]
        est = c._est_normals[: c.n].double().cpu().numpy()
        q001 = float(np.quantile(np.abs((est * lapack[name]).sum(1)), 0.001))
        print(f"estimation {name}: {c.n} points, {bad} k-NN rows differ from "
              f"the float64 oracle; normals |dot| 0.001-quantile {q001:.6f} "
              "vs float64 LAPACK", flush=True)
        if bad:
            raise AssertionError(f"estimation {name}: {bad} k-NN rows differ")
        if not q001 > 0.999:
            raise AssertionError(f"estimation {name}: normals |dot| "
                                 f"0.001-quantile {q001} <= 0.999")
        out[name] = {"knn_rows_differ": bad, "normals_dot_q001": q001}
    want = _want_psnrs(origin, reconst, sweeps, lapack["origin"],
                       lapack["reconst"])
    deltas = _psnr_deltas(result, want)
    d2 = max(v for k, v in deltas.items() if k.startswith("d2_"))
    rest = max(v for k, v in deltas.items() if not k.startswith("d2_"))
    print(f"estimation max |dPSNR| vs float64 evaluation: D2 entries "
          f"{d2:.3e} dB (bar {D2_TOL:g}), D1/colour/Hausdorff {rest:.3e} dB "
          f"(bar {PSNR_TOL:g})", flush=True)
    if not (d2 <= D2_TOL and rest <= PSNR_TOL):
        raise AssertionError(f"estimation PSNR parity: D2 {d2:.3e}, "
                             f"others {rest:.3e}")
    out["max_dpsnr_d2"], out["max_dpsnr_other"] = d2, rest
    return out


def main() -> int:
    import torch

    import bench
    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # No TF32: every float32 product stays full float32 (stated and set).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)

    t0 = time.perf_counter()
    built = _build.load_many(list(KERNELS))
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, in parallel)", flush=True)
    for name, lib in built.items():
        print(f"build: csrc/{name}.cu -> {lib.path} in "
              f"{lib.build_seconds:.2f} s", flush=True)
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas {name}: " + line.strip())

    t0 = time.perf_counter()
    origin, reconst = bench.make_clouds(N_POINTS)
    rng = np.random.default_rng(1)
    float_pts = origin[0] + rng.uniform(-0.5, 0.5, origin[0].shape)
    print(f"clouds: {origin[0].shape[0]} + {reconst[0].shape[0]} points "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    a = Cloud.from_numpy(origin[0], device=dev)
    b = Cloud.from_numpy(reconst[0], device=dev)
    fcloud = Cloud.from_numpy(float_pts, device=dev)
    records = kernel_phases(a, b, fcloud)
    k3_recs, k4_recs = knn_phases(a, fcloud)
    del a, b, fcloud
    torch.cuda.empty_cache()

    a, b, result, first_s, times, launches = main_path(origin, reconst, dev)
    n_total = a.n + b.n
    med = statistics.median(times)
    print("main path " + json.dumps({
        "n_points": n_total, "first_call_s": first_s,
        "times_s": times, "median_s": med,
        "mpts_per_s": n_total / med / 1e6, "k1_launches": launches["refine_nn"],
        "card": smi,
    }), flush=True)
    sweeps = oracle_checks(a, b, origin, reconst, result)
    del a, b
    torch.cuda.empty_cache()

    ea, eb, est_result, est_first, est_times, est_launches = estimation_path(
        origin, reconst, dev)
    est_med = statistics.median(est_times)
    print("estimation path " + json.dumps({
        "n_points": n_total, "first_call_s": est_first,
        "times_s": est_times, "median_s": est_med,
        "mpts_per_s": n_total / est_med / 1e6,
        "k1_launches": est_launches["refine_nn"],
        "k3_launches": est_launches["refine_knn"],
        "k4_launches": est_launches["knn_moments"],
        "card": smi,
    }), flush=True)
    estimation_checks(ea, eb, origin, reconst, est_result, sweeps)

    for name in ("jax", "open_pcc_metric_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")
    path_launches = {"refine_nn": launches["refine_nn"],
                     "refine_knn": est_launches["refine_knn"],
                     "knn_moments": est_launches["knn_moments"]}
    phase_recs = {"refine_nn": records, "refine_knn": k3_recs,
                  "knn_moments": k4_recs}
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"open_pcc_metric_tpu_torch/csrc/{name}.cu",
        "replaces": KERNELS[name],
        "launches": path_launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in phase_recs[name]),
        "ms": _full_phase(phase_recs[name])["ms"],
        "plain_ms": _full_phase(phase_recs[name])["plain_ms"],
    } for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
