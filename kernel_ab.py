"""K2b and K1c of two checkouts of the PyTorch port, in turns, and the SASS
of every kernel of both.

    python3 kernel_ab.py PARENT_DIR CHANGE_DIR [--rounds 1]

Each checkout is a directory holding ``open_pcc_metric_tpu_torch`` (for
example a ``git archive`` of a commit, unpacked). The script makes the 800k
and 2M pairs of ``bench.make_clouds`` once, then runs one worker process a
turn in the order parent, change, change, parent, ``--rounds`` times. A
worker imports the package of its own checkout only, builds the kernels
it has of ``chip_smoke.KERNELS`` and times, with this checkout's ``chip_smoke.py`` helpers:

  * K2b (``count_bbox``) at the select prologue's shapes (800k a->b, b->a,
    self; 2M a->b, self) at the probe's threshold, eager (``ms``) and in a
    CUDA graph (``graph_ms``), its counts equal to the plain version's;
  * the 2M select prologue, K2a and two K2b counts a sweep, against the
    bound-matrix prologue (``chip_smoke.prologue_ab``);
  * K1c (``refine_nn_fused``) beside K1b (``refine_nn_straight``) on the
    fixed schedule's 800k stage-1 tables (a->b, b->a, self), d and id
    equal to K1b's.

Last, it disassembles each kernel's library of both checkouts
(``cuobjdump -sass``) and says which compile to the same instructions. It
prints one JSON line a turn, one line a kernel for the SASS, and the card's
name and power limit. Needs one CUDA device; it exits non-zero without
one, or when a worker or a check fails.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_POINTS, N_BIG = 800_000, 2_000_000


def _smoke():
    """This checkout's chip_smoke.py as a module (its helpers import the
    package lazily, so they use the worker's checkout)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, clouds: str) -> dict:
    """The timings of one process on the checkout ``tree``."""
    sys.path[0] = os.path.abspath(tree)  # that checkout's package, not ours
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops import _build
    from open_pcc_metric_tpu_torch.ops.nn_pruned import cert_ub, tile_boxes
    from open_pcc_metric_tpu_torch.ops.refine import (
        refine_nn, refine_nn_fused, refine_nn_straight)
    from open_pcc_metric_tpu_torch.ops.select import (
        count_bbox, count_bbox_reference, select_bbox)

    cs = _smoke()
    dev = torch.device("cuda", 0)
    names = [n for n in cs.KERNELS  # an older checkout lacks newer kernels
             if os.path.exists(os.path.join(_build.CSRC_DIR, f"{n}.cu"))]
    libs = {name: lib.path
            for name, lib in _build.load_many(names).items()}
    data = np.load(clouds)
    grids = {k: Cloud.from_numpy(data[k], device=dev)
             for k in ("a", "b", "big_a", "big_b")}
    n = {k: c.n for k, c in grids.items()}
    grids = {k: c.get_grid() for k, c in grids.items()}

    k2b = {}
    for name, q, s, ex in (("800k a->b", "a", "b", False),
                           ("800k b->a", "b", "a", False),
                           ("800k self a->a", "a", "a", True),
                           ("2M a->b", "big_a", "big_b", False),
                           ("2M self a->a", "big_a", "big_a", True)):
        gq, gs = grids[q], grids[s]
        valid_t, a_lo, a_hi = tile_boxes(gq, n[q])
        boxes = (a_lo, a_hi, gs.bbox_lo, gs.bbox_hi)
        cand, _ = select_bbox(*boxes, min(cs.CAP, gs.n_chunks))
        d1, _ = refine_nn(gq.points, gs.points, gs.perm,
                          cand[:, :cs.P1].contiguous(), exclude_self=ex)
        thr = cert_ub(d1, valid_t)
        if not cs._bit_equal(count_bbox(*boxes, thr),
                             count_bbox_reference(*boxes, thr)):
            raise AssertionError(f"K2b {name} differs from the plain version")
        k2b[name] = {
            "ms": cs._time_ms(lambda: count_bbox(*boxes, thr), 20),
            "graph_ms": cs._graph_ms(lambda: count_bbox(*boxes, thr), 20)}
    ga, gb = grids["big_a"], grids["big_b"]
    prologue = cs.prologue_ab("2M", [
        ("a->b", ga, gb, n["big_a"], False),
        ("b->a", gb, ga, n["big_b"], False),
        ("self a->a", ga, ga, n["big_a"], True)], "see the card line")

    k1c = {}
    for name, q, s, ex in (("800k a->b", "a", "b", False),
                           ("800k b->a", "b", "a", False),
                           ("800k self a->a", "a", "a", True)):
        gq, gs = grids[q], grids[s]
        cand = cs.fixed_table(gq, gs, n[q], cs.CAP)[2]
        args = (gq.points, gs.points, gs.perm, cand)
        want = refine_nn_straight(*args, exclude_self=ex)
        got = refine_nn_fused(*args, exclude_self=ex)
        if not all(cs._bit_equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"K1c {name} differs from K1b")
        k1c[name] = {
            fn.__name__: cs._time_ms(lambda fn=fn: fn(*args, exclude_self=ex),
                                     20)
            for fn in (refine_nn_fused, refine_nn_straight)}
    return {"tree": tree, "libraries": libs, "count_bbox": k2b,
            "prologue_2m": prologue, "refine_nn_fused": k1c}


def _sass(path: str) -> list:
    """The instructions of a library's kernels: cuobjdump -sass without
    addresses, encodings and the file header."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME, "bin",
                                                      "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    keep = []
    for line in out.splitlines():
        line = re.sub(r"/\*[0-9a-fx ]*\*/", "", line).strip()
        # an anonymous namespace's mangled name holds hashes of the path
        line = re.sub(r"_GLOBAL__N__\w+", "_GLOBAL__N_", line)
        if line and not line.startswith(("Fatbin", "code for", "arch =",
                                         "code version", "host =",
                                         "compile_size", ".")):
            keep.append(line)
    return keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--clouds", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.clouds)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    sys.path.insert(0, HERE)
    import bench

    origin, reconst = bench.make_clouds(N_POINTS)
    big_o, big_r = bench.make_clouds(N_BIG)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        clouds = os.path.join(tmp, "clouds.npz")
        np.savez(clouds, a=origin[0], b=reconst[0], big_a=big_o[0],
                 big_b=big_r[0])
        order = ["parent", "change", "change", "parent"] * args.rounds
        for turn, side in enumerate(order):
            tree = getattr(args, side)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.parent,
                 args.change, "--worker", tree, "--clouds", clouds],
                capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            libs[side] = rec.pop("libraries")
            print(f"turn {turn} {side} " + json.dumps(rec), flush=True)
    for name in libs["change"]:
        if name not in libs["parent"]:
            print(f"sass {name}: new in the change", flush=True)
            continue
        old, new = _sass(libs["parent"][name]), _sass(libs["change"][name])
        diff = [(x, y) for x, y in zip(old, new) if x != y][:2]
        same = "identical" if old == new else f"differs, first {diff}"
        print(f"sass {name}: {same} ({len(old)} and {len(new)} lines)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
