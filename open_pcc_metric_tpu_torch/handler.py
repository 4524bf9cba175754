"""Command line — flag-for-flag parity with the JAX package's CLI.

Reference surface (open_pcc_metric/handler.py:4-43):
  --ocloud --pcloud --color {rgb,ycc} --hausdorff --point-to-plane --csv

Extensions: --color yuv, --color-hausdorff, --d2-mode {reference,pc_error},
--peak/--resolution (pc_error's PSNR peak convention), --dtype, --backend,
--trace-dir and --timings (as the JAX package's CLI: a torch.profiler
trace, of the loads too, and the evaluation's wall time on stderr), and
--device (default cuda). A CUDA device that is not there is an error: the
CLI never falls back to the CPU on its own.
"""
from __future__ import annotations

import argparse
import sys
import time
import typing

from .ops.nn import BACKENDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m open_pcc_metric_tpu_torch",
        description="Point-cloud compression quality metrics (PyTorch).")
    p.add_argument("--ocloud", required=True, help="Original point cloud.")
    p.add_argument("--pcloud", required=True, help="Processed point cloud.")
    p.add_argument("--color", choices=["rgb", "ycc", "yuv"],
                   help="Report color distortions as well.")
    p.add_argument("--hausdorff", action="store_true",
                   help="Report hausdorff metric as well. If --point-to-plane "
                        "is provided, then hausdorff point-to-plane would be "
                        "reported too")
    p.add_argument("--point-to-plane", action="store_true",
                   help="Report point-to-plane distance as well.")
    p.add_argument("--csv", action="store_true",
                   help="Print output in csv format.")
    p.add_argument("--color-hausdorff", action="store_true",
                   help="Also report per-channel color Hausdorff distance/PSNR.")
    p.add_argument("--d2-mode", choices=["reference", "pc_error"],
                   default="reference",
                   help="Normal convention for point-to-plane (D2) projection "
                        "(default: reference).")
    p.add_argument("--peak", "--resolution", type=float, default=None,
                   help="User-supplied signal peak for every geometric PSNR "
                        "(pc_error's --resolution convention) instead of the "
                        "reference's OBB-extent / intra-NN-distance peaks.")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32",
                   help="Compute dtype (the CUDA kernels take float32, so "
                        "float64 needs --device cpu; default: float32).")
    p.add_argument("--backend", choices=list(BACKENDS), default="auto",
                   help="NN backend: brute (pallas and jnp are its aliases) "
                        "or pruned; auto takes the brute force below 65536 "
                        "padded rows and the pruned search above "
                        "(default: auto).")
    p.add_argument("--trace-dir", default=None,
                   help="Write a torch.profiler trace of the loads and "
                        "the evaluation to this directory.")
    p.add_argument("--timings", action="store_true",
                   help="Print wall time and Mpoints/sec to stderr.")
    p.add_argument("--device", default="cuda",
                   help="Torch device to evaluate on (default: cuda).")
    return p


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch

    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        parser.error(f"--device {args.device!r}: {e}")
    if device.type == "cuda" and args.dtype == "float64":
        parser.error("--dtype float64 runs on the CPU only: the CUDA kernels "
                     "take float32 (pass --device cpu, or --dtype float32)")
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to evaluate on the CPU)")

    from .evaluate import _load_pair, evaluate_pair
    from .options import CalculateOptions
    from .utils.profiling import mpoints_per_sec, trace

    options = CalculateOptions(
        color=args.color,
        hausdorff=args.hausdorff,
        point_to_plane=args.point_to_plane,
        color_hausdorff=args.color_hausdorff,
        d2_mode=args.d2_mode,
        peak=args.peak,
    )
    with trace(args.trace_dir):
        a, b = _load_pair(args.ocloud, args.pcloud, args.dtype, device,
                          args.peak)
        t0 = time.perf_counter()
        result = evaluate_pair(a, b, options, backend=args.backend)
        if device.type == "cuda":  # the wall, not the launch queue
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    if args.timings:
        print(f"evaluated {a.n}+{b.n} points in {wall:.3f}s "
              f"({mpoints_per_sec(a.n + b.n, wall):.3f} Mpoints/s)",
              file=sys.stderr)
    if args.csv:
        print(result.to_csv())
    else:
        print(result.to_string())
    return 0


def cli() -> None:
    sys.exit(main())
