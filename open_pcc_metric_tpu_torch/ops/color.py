"""Colour-space transforms and peaks, matching the reference bit-for-bit.

Port of ``open_pcc_metric_tpu/ops/color.py``. Reference semantics:
  * rgb->ycc uses the BT.709 full-range matrix (reference: metric.py:270-275),
  * rgb->yuv uses the reference's integer-ish matrix (metric.py:276-281),
  * identity when source == target (metric.py:266-267),
  * colour peak: rgb -> 255.0 although colours live in [0,1] — the reference's
    acknowledged inconsistency, SURVEY Q5 (metric.py:293-299).

The 3x3 matrix is unrolled into elementwise multiply-adds, NOT a matmul: a
float32 product may run in reduced precision (TF32 on the GPU, bf16 passes
on the TPU), and reduced precision moved the colour-Hausdorff PSNR by
0.33 dB against the f64 oracle. The unrolled form is full float32 anywhere.
"""
from __future__ import annotations

import numpy as np
import torch

_RGB_TO_YCC = np.array(
    [
        [0.2126, 0.7152, 0.0722],
        [-0.1146, -0.3854, 0.5],
        [0.5, -0.4542, -0.0458],
    ]
)

_RGB_TO_YUV = np.array(
    [
        [0.25, 0.5, 0.25],
        [1.0, 0.0, -1.0],
        [-0.5, 1.0, -0.5],
    ]
)

COLOR_SCHEMES = ("rgb", "ycc", "yuv")


def color_matrix(source_scheme: str, target_scheme: str) -> np.ndarray:
    if source_scheme == target_scheme:
        return np.eye(3)
    if (source_scheme, target_scheme) == ("rgb", "ycc"):
        return _RGB_TO_YCC
    if (source_scheme, target_scheme) == ("rgb", "yuv"):
        return _RGB_TO_YUV
    raise ValueError(
        f"unsupported colour transform {source_scheme!r} -> {target_scheme!r}"
    )


def transform_colors(
    colors: torch.Tensor, source_scheme: str, target_scheme: str
) -> torch.Tensor:
    """(N, 3) colour transform against the reference matrices, in the
    colours' dtype: each output channel is ((c0*m0 + c1*m1) + c2*m2) with
    the coefficients rounded to that dtype."""
    if source_scheme == target_scheme:
        return colors
    # Host 0-d coefficients: a device op reads a CPU scalar without a copy
    # to the device (and so without a wait on one).
    m = torch.as_tensor(color_matrix(source_scheme, target_scheme),
                        dtype=colors.dtype)
    cols = []
    for r in range(3):
        acc = None
        for c in range(3):
            term = colors[..., c] * m[r, c]
            acc = term if acc is None else acc + term
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def get_color_peak(color_scheme: str) -> float:
    peaks = {"rgb": 255.0, "ycc": 1.0, "yuv": 1.0}
    return peaks[color_scheme]
