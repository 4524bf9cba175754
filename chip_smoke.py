#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (open_pcc_metric_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernel from ``open_pcc_metric_tpu_torch/csrc``,
checks it bit for bit against its plain PyTorch version at the shapes the
main path gives it, drives the main path (``fused_evaluate`` on bench.py's
800k-point voxelised pair, ycc + point-to-plane + pc_error + Hausdorff),
checks the three NN sweeps against an exact float64 scipy oracle and the
PSNRs against a float64 numpy evaluation, and prints:

  * the card's name and power limit (nvidia-smi),
  * the kernel's build time and ptxas resource lines,
  * one line per kernel phase, the main-path timing line,
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
CAP, FALLBACK, P1 = 32, 256, 8  # the main path's base rung and probe width


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


def kernel_phases(a, b, float_cloud):
    """K1 against refine_nn_reference on the card, at main-path shapes.

    Returns one record per phase: the call's shape, the largest |d| error
    (0 when bit-identical, which is required), and both times.
    """
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import stable_top, tile_bounds
    from open_pcc_metric_tpu_torch.ops.refine import (
        refine_nn, refine_nn_reference)

    eps = torch.finfo(torch.float32).eps

    def counts_of(d, lb, valid_t):
        ub = torch.where(valid_t, d, -torch.inf).amax(dim=1)
        ub_eff = ub * (1 + 8 * eps) + 8 * eps
        return (lb <= ub_eff[:, None]).sum(dim=1, dtype=torch.int32)

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
    ncand2 = torch.clamp(counts_of(d1, lb, valid_t) - P1, 0, CAP - P1).int()
    d2, i2, rec = check("extension a->b", ga, gb, order[:, P1:CAP],
                        ncand=ncand2, init=(d1, i1))
    records.append(rec)
    # Compacted tier-A tiles, read in place through global tile ids.
    counts = counts_of(d2, lb, valid_t)
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
    ncand_f = torch.clamp(counts_of(df, lb_f, valid_f) - P1, 0, CAP - P1).int()
    records.append(check("float extension", gf, gb, order_f[:, P1:CAP],
                         ncand=ncand_f, init=(df, i_f))[2])
    return records


def main_path(origin, reconst, dev):
    """fused_evaluate on the card: one warm-up, then the median of RUNS."""
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops import refine
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    a = Cloud.from_numpy(origin[0], colors=origin[1], normals=origin[2],
                         device=dev)
    b = Cloud.from_numpy(reconst[0], colors=reconst[1], normals=reconst[2],
                         device=dev)
    torch.cuda.synchronize()
    plain = refine.refine_nn_reference

    def guard(q_sorted, *args, **kw):
        if q_sorted.is_cuda:
            raise AssertionError("a CUDA tensor reached refine_nn_reference")
        return plain(q_sorted, *args, **kw)

    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    refine.refine_nn_reference = guard
    try:
        refine.refine_nn.launches = 0
        t0 = time.perf_counter()
        result = fused_evaluate(a, b, **kwargs)  # builds grids, caches, self-NN
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            result = fused_evaluate(a, b, **kwargs)  # ends in a host readback
            times.append(time.perf_counter() - t0)
        launches = refine.refine_nn.launches
    finally:
        refine.refine_nn_reference = plain
    if launches <= 0:
        raise AssertionError("the main path launched K1 no time")
    return a, b, result, first_s, times, launches


def oracle_checks(a, b, origin, reconst, result):
    """The three NN sweeps bit-exact vs the scipy float64 oracle, and the
    PSNRs vs a float64 numpy evaluation built from the oracle neighbours."""
    import bench
    from open_pcc_metric_tpu_torch.ops.fused import _LADDER_MEMO
    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        nn_pruned_sorted, unsort_nn_result)
    from open_pcc_metric_tpu_torch.ops.obb import minimal_obb_extent

    pts0, col0, nrm0 = origin
    pts1, col1, nrm1 = reconst
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
    delta = max(float(np.max(np.abs(np.asarray(result[k], np.float64) - v)))
                for k, v in want.items())
    print(f"max |dPSNR| vs float64 oracle evaluation: {delta:.3e} dB "
          f"({len(want)} PSNR entries)", flush=True)
    if not delta <= 1e-4:
        raise AssertionError(f"PSNR parity: max |delta| {delta:.3e} > 1e-4 dB")
    return delta


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

    built = _build.load("refine_nn")
    print(f"build: csrc/refine_nn.cu -> {built.path} in "
          f"{built.build_seconds:.2f} s", flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("ptxas: " + line.strip())

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
    del a, b, fcloud

    a, b, result, first_s, times, launches = main_path(origin, reconst, dev)
    n_total = a.n + b.n
    med = statistics.median(times)
    print("main path " + json.dumps({
        "n_points": n_total, "first_call_s": first_s,
        "times_s": times, "median_s": med,
        "mpts_per_s": n_total / med / 1e6, "k1_launches": launches,
        "card": smi,
    }), flush=True)
    oracle_checks(a, b, origin, reconst, result)

    for name in ("jax", "open_pcc_metric_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")
    probe = records[0]
    print(json.dumps({"kernels": [{
        "name": "refine_nn",
        "route": "cuda",
        "source": "open_pcc_metric_tpu_torch/csrc/refine_nn.cu",
        "replaces": "open_pcc_metric_tpu/ops/refine_pallas.py:575",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": probe["ms"],
        "plain_ms": probe["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
