"""Readings for the correctness limits of one cell.

    python3 portbench/calibrate.py --workload <cell> --seeds S [S ...] \\
        --control-seeds C [C ...] [--seconds N] [--out FILE]

For each program seed: one run of the cell (set-up, a window of
``--seconds``, the reference) and the widest gap of each compared number
over the window's tables (the lower readings). For each control seed: the
reference computed in TF32 (``reference/oracle.py``) put in the program's
place over every pair of the cell, against the float64 reference (the
upper readings). One JSON line a seed, on standard output and appended to
``--out``. The program's runs need the card; the control's do not.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

from portbench import harness  # noqa: E402
from portbench.data import generate  # noqa: E402
from portbench.judge import PARTS, gaps, reference_tables  # noqa: E402


def worst(tables: dict, reference: dict) -> dict:
    out = dict.fromkeys(PARTS, 0.0)
    for key, table in tables:
        for part, v in gaps(table, reference[key]).items():
            out[part] = max(out[part], v)
    return out


def program_reading(manifest, cell, seed, seconds, device="cuda"):
    run = harness.execute(manifest, cell, seed, seconds, False, device,
                          log=lambda s: None)
    cfg = run.config
    done = [(p.key, p.table) for p in run.pairs if p.table is not None]
    t = time.perf_counter()
    ref = reference_tables(run.groups, cfg["options"], {k for k, _ in done},
                           reference_normals=cfg["reference_normals"],
                           dtype=cfg["dtype"])
    return dict(worst(done, ref["float64"]), kind="program", seed=seed,
                pairs=len(run.pairs), failed=len(run.pairs) - len(done),
                reference_s=time.perf_counter() - t,
                setup_s=run.setup["setup_s"])


def control_reading(manifest, cell, seed, config_overrides=None,
                    workers=-1):
    cfg = dict(manifest.config(manifest.cell(cell)["config"]),
               **(config_overrides or {}))
    with tempfile.TemporaryDirectory(prefix="portbench-") as d:
        groups = generate.make_groups(cfg, seed, d)
    keys = {f.tag for g in groups for f in g.degraded}
    t = time.perf_counter()
    ref = reference_tables(groups, cfg["options"], keys, ("float64", "tf32"),
                           cfg["reference_normals"], cfg["dtype"], workers)
    return dict(worst(ref["tf32"].items(), ref["float64"]), kind="control",
                seed=seed, pairs=len(keys),
                reference_s=time.perf_counter() - t)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    manifest = harness.Manifest()
    for seed in args.seeds + args.control_seeds:
        if seed in args.seeds:
            row = program_reading(manifest, args.workload, seed, args.seconds)
        else:
            row = control_reading(manifest, args.workload, seed)
        row["workload"] = args.workload
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
