"""Cold estimation calls of two checkouts of the PyTorch port, in turns.

    python3 cold_ab.py PARENT_DIR CHANGE_DIR [--rounds 2] [--calls 7]

Each checkout is a directory holding ``open_pcc_metric_tpu_torch`` (for
example a ``git archive`` of a commit, unpacked). The script makes the 800k
pair of ``bench.make_clouds`` once, then runs one worker process per turn in
the order parent, change, change, parent, ``--rounds`` times. A worker
imports the package of its own checkout only, makes one warm-up call
(kernels built and loaded), then ``--calls`` timed cold calls and one call
under ``torch.profiler``: ``fused_evaluate`` with the full suite (ycc,
point-to-plane, ``pc_error``) on fresh clouds without normals, so each call
builds both grids and estimates both clouds' normals, as ``chip_smoke.py``'s
estimation path does. The call overlaps the host's OBB hull (a thread) with
the NN passes, so the worker also times ``--calls`` cold calls given the
peak (no hull: the NN passes and their host work alone), the hull alone on
fresh clouds, ``--calls`` cold calls with the hull's phases timed (when
the main thread starts waiting for it, and the hull thread's start, qhull,
device projection sweep and end, from the call's start), and one call
given the peak under ``cProfile`` (the main thread's functions of most own
time). It prints one JSON line a worker
with every call's wall seconds, and a last line with each checkout's calls
pooled. Needs one CUDA device; it exits non-zero without one, or when a
worker fails.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_POINTS = 800_000


def worker(tree: str, clouds: str, calls: int) -> dict:
    """The turns of one process on the checkout ``tree``."""
    sys.path[0] = os.path.abspath(tree)  # that checkout's package, not ours
    import torch
    from torch.profiler import ProfilerActivity, profile

    import open_pcc_metric_tpu_torch
    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    dev = torch.device("cuda", 0)
    data = np.load(clouds)

    def make():
        a = Cloud.from_numpy(data["a_pts"], colors=data["a_col"], device=dev)
        b = Cloud.from_numpy(data["b_pts"], colors=data["b_col"], device=dev)
        torch.cuda.synchronize()
        return a, b

    def call(a, b, peak=None):
        t0 = time.perf_counter()
        fused_evaluate(a, b, color_scheme="ycc", point_to_plane=True,
                       d2_mode="pc_error", peak=peak)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def hull():
        a, _ = make()
        t0 = time.perf_counter()
        extent = a.get_obb_extent()
        return time.perf_counter() - t0, float(np.max(extent))

    def phased(a, b):
        """One cold call with the hull's phases timed (seconds from the
        call's start), by wrapping module attributes in this process."""
        import scipy.spatial

        from open_pcc_metric_tpu_torch.ops import fused, obb

        marks = {}
        t0 = time.perf_counter()

        def timed(key, fn):
            def run(*args, **kw):
                marks.setdefault(key + "_start", time.perf_counter() - t0)
                out = fn(*args, **kw)
                marks[key + "_end"] = time.perf_counter() - t0
                return out
            return run

        class Waited:
            def __init__(self, fut):
                self.fut = fut

            def result(self):
                marks["main_waits_at"] = time.perf_counter() - t0
                return self.fut.result()

        saved = (obb.minimal_obb_extent, obb._frame_extents,
                 scipy.spatial.ConvexHull, fused._prefetch_obb)
        obb.minimal_obb_extent = timed("hull", saved[0])
        obb._frame_extents = timed("sweep", saved[1])
        scipy.spatial.ConvexHull = timed("qhull", saved[2])
        fused._prefetch_obb = lambda *args: (
            lambda f: None if f is None else Waited(f))(saved[3](*args))
        try:
            fused_evaluate(a, b, color_scheme="ycc", point_to_plane=True,
                           d2_mode="pc_error")
            torch.cuda.synchronize()
            marks["wall"] = time.perf_counter() - t0
        finally:
            (obb.minimal_obb_extent, obb._frame_extents,
             scipy.spatial.ConvexHull, fused._prefetch_obb) = saved
        return marks

    warm_s = call(*make())
    times = [call(*make()) for _ in range(calls)]
    phases = [phased(*make()) for _ in range(calls)]
    hull_s, peak = zip(*(hull() for _ in range(3)))
    no_hull = [call(*make(), peak=peak[0]) for _ in range(calls)]
    host = cProfile.Profile()
    a, b = make()
    host.runcall(call, a, b, peak[0])
    top = pstats.Stats(host).sort_stats("tottime")
    host_top = [
        [f"{os.path.basename(f)}:{line}:{fn}", st[1], st[2], st[3]]
        for (f, line, fn), st in sorted(
            top.stats.items(), key=lambda kv: -kv[1][2])[:15]]
    a, b = make()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = call(a, b)
    busy_ms = sum(
        getattr(ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        for ev in prof.key_averages()
        if str(ev.device_type).endswith("CUDA"))
    return {"tree": tree,
            "package": os.path.dirname(open_pcc_metric_tpu_torch.__file__),
            "warm_up_s": warm_s, "times_s": times,
            "times_no_hull_s": no_hull, "hull_s": list(hull_s),
            "phases_s": phases,
            "host_top_by_own_s": host_top,
            "profiled_wall_s": prof_wall,
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "idle_share": (1 - busy_ms / 1e3 / prof_wall if busy_ms > 0
                           else "not measured")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=7)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--clouds", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.clouds, args.calls)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("cold_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    import bench

    origin, reconst = bench.make_clouds(N_POINTS)
    pooled = {"parent": [], "change": []}
    no_hull = {"parent": [], "change": []}
    hull = {"parent": [], "change": []}
    phases = {"parent": [], "change": []}
    profiled = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        clouds = os.path.join(tmp, "clouds.npz")
        np.savez(clouds, a_pts=origin[0], a_col=origin[1], b_pts=reconst[0],
                 b_col=reconst[1])
        order = ["parent", "change", "change", "parent"] * args.rounds
        for turn, side in enumerate(order):
            tree = getattr(args, side)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.parent,
                 args.change, "--worker", tree, "--clouds", clouds,
                 "--calls", str(args.calls)],
                capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            pooled[side] += rec["times_s"]
            no_hull[side] += rec["times_no_hull_s"]
            hull[side] += rec["hull_s"]
            phases[side] += rec["phases_s"]
            profiled[side].append(rec["profiled_wall_s"])
            print(f"turn {turn} {side} " + json.dumps(rec), flush=True)
    summary = {
        side: {"calls": len(t), "median_s": statistics.median(t),
               "min_s": min(t), "max_s": max(t),
               "no_hull_median_s": statistics.median(no_hull[side]),
               "no_hull_min_s": min(no_hull[side]),
               "no_hull_max_s": max(no_hull[side]),
               "hull_median_s": statistics.median(hull[side]),
               "phases_median_s": {
                   k: statistics.median(m[k] for m in phases[side])
                   for k in phases[side][0]},
               "profiled_wall_s": profiled[side]}
        for side, t in pooled.items()}
    print(json.dumps({"n_points": origin[0].shape[0] + reconst[0].shape[0],
                      "order": order, "pooled": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
