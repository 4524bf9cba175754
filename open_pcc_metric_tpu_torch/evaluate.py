"""High-level evaluation entry points (the programmatic API).

Port of ``open_pcc_metric_tpu/evaluate.py``, the reference's library path
(SURVEY §3.4): load clouds onto a torch device (the CUDA device unless one
is named), then evaluate the reference-ordered metric table with the fused
engine or the lazy metric DAG (``CloudPair -> MetricCalculator``).
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from . import metric as M
from .calculator import CalculateResult, MetricCalculator
from .cloud import Cloud, resolve_device
from .cloud_pair import CloudPair
from .io import ply_decode, read_point_cloud
from .io.loaders import _read_point_cloud_staged
from .options import CalculateOptions, transform_options
from .utils.profiling import new_pair, span

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

Device = typing.Union[str, torch.device, None]


def load_cloud(
    path: str,
    dtype: str = "float32",
    pad_to: typing.Optional[int] = None,
    *,
    device: Device = None,
) -> Cloud:
    """Read a cloud file onto ``device`` (the CUDA device when None; raises
    when there is none), padded to ``pad_to`` or its own bucket. ``thin``
    stays "auto", as in the JAX package: on a CUDA device integer points
    and 8-bit colours upload narrow and widen there (``Cloud.from_numpy``).
    A float32 load onto a CUDA device of a binary little-endian PLY with
    the vertex element first and scalar properties only uploads the raw
    records and splits them on the card into the same bits
    (``io/ply_decode.py``)."""
    return _load_cloud(path, dtype, pad_to, device)


def _load_cloud(path, dtype, pad_to, device, on_points=None) -> Cloud:
    """``load_cloud``, handing the (N, 3) float64 points to ``on_points``
    (where given) the moment they exist, before the upload."""
    with span("pcc.load"):
        with span("pcc.parse"):
            staged = ply_decode.stage(path, dtype, device)
            points = None
            if staged is None:
                raw = (read_point_cloud(path) if on_points is None else
                       _read_point_cloud_staged(path, on_points))
            elif on_points is not None:
                points = staged.host_points()
                on_points(points)
        with span("pcc.upload"):
            if staged is not None:
                return staged.upload(pad_to, points)
            return Cloud.from_numpy(
                raw.points,
                colors=raw.colors,
                normals=raw.normals,
                device=device,
                dtype=_DTYPES[dtype],
                pad_to=pad_to,
            )


def _load_pair(
    ocloud: str,
    pcloud: str,
    dtype: str,
    device: Device,
    peak: typing.Optional[float],
) -> typing.Tuple[Cloud, Cloud]:
    """``load_cloud`` of both files. Without a user ``peak`` the origin's
    minimal-OBB hull starts on a thread of its own the moment its float64
    points are parsed (before its colours, normals and upload, and before
    the other file is read), on the array ``Cloud.valid_points`` returns;
    the origin holds it as its pending OBB extent, which the evaluation
    waits for (``obb.start_obb_extent``)."""
    from .ops import obb

    hull = None

    def start(points):
        nonlocal hull
        points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:  # the cloud's card
            dev = torch.device("cuda", torch.cuda.current_device())
        with span("pcc.obb.early"):
            hull = obb.start_obb_extent(lambda: points, dev)

    origin = _load_cloud(ocloud, dtype, None, device,
                         start if peak is None else None)
    if hull is not None:
        origin._obb_extent = hull
    return origin, load_cloud(pcloud, dtype=dtype, device=device)


def evaluate_pair(
    origin: Cloud,
    reconst: Cloud,
    options: typing.Optional[CalculateOptions] = None,
    backend: str = "auto",
    engine: str = "auto",
) -> CalculateResult:
    """Evaluate the option-selected metric table for one pair, on the
    clouds' device.

    engine:
      * "fused" (and "auto") — one fused evaluation + host epilogue
        (ops/fused.py); covers every metric reachable from CalculateOptions.
      * "dag" — the reference-shaped lazy metric DAG (CloudPair +
        MetricCalculator); use for custom or partial metric lists.
    Both give the same table. ``backend``: "auto", "pruned" or "brute"
    (aliases "pallas", "jnp"), as ``ops/nn.resolve_backend`` reads it.
    """
    options = options or CalculateOptions()
    if engine == "auto":
        engine = "fused"
    if engine == "fused":
        return _evaluate_pair_fused(origin, reconst, options, backend)
    if engine != "dag":
        raise ValueError(f"unknown engine {engine!r}")
    calculator = MetricCalculator(CloudPair(origin, reconst, backend=backend))
    return calculator.calculate(transform_options(options))


def _evaluate_pair_fused(
    origin: Cloud,
    reconst: Cloud,
    options: CalculateOptions,
    backend: str,
) -> CalculateResult:
    """Fill the reference-ordered metric table from one fused evaluation."""
    from .ops.fused import fused_evaluate

    stats = fused_evaluate(
        origin,
        reconst,
        color_scheme=options.color,
        point_to_plane=options.point_to_plane,
        d2_mode=options.d2_mode,
        backend=backend,
        peak=options.peak,
    )

    def value_for(m) -> typing.Any:
        child = m.metrics[0] if isinstance(m, M.SymmetricMetric) else m
        name = child.__class__.__name__
        boundary = {"MinSqrtDistance": "min_sqrt", "MaxSqrtDistance": "max_sqrt"}
        if name in boundary:
            return np.float64(stats[boundary[name]])
        if isinstance(m, M.SymmetricMetric):
            side = "sym"
        else:
            side = "left" if child.is_left else "right"
        geo = "d2_" if getattr(child, "point_to_plane", False) else "geo_"
        keys = {
            "GeoMSE": geo + "mse_",
            "GeoPSNR": geo + "psnr_",
            "GeoHausdorffDistance": geo + "hausdorff_",
            "GeoHausdorffDistancePSNR": geo + "hausdorff_psnr_",
            "ColorMSE": "color_mse_",
            "ColorPSNR": "color_psnr_",
            "ColorHausdorffDistance": "color_hausdorff_",
            "ColorHausdorffDistancePSNR": "color_hausdorff_psnr_",
        }
        arr = np.asarray(stats[keys[name] + side], dtype=np.float64)
        return np.float64(arr) if arr.ndim == 0 else arr

    metrics = transform_options(options)
    for m in metrics:
        m.value = value_for(m)
        if isinstance(m, M.SymmetricMetric):
            for child in m.metrics:
                child.value = value_for(child)
    return CalculateResult(metrics)


def evaluate_files(
    ocloud: str,
    pcloud: str,
    options: typing.Optional[CalculateOptions] = None,
    dtype: str = "float32",
    backend: str = "auto",
    *,
    device: Device = None,
) -> CalculateResult:
    """Load two files onto ``device`` (the CUDA device when None; raises
    when there is none) and evaluate them with ``evaluate_pair``. Without a
    user peak the origin's hull starts as soon as its points are parsed."""
    options = options or CalculateOptions()
    with span("pcc.pair", pair=new_pair()):
        origin, reconst = _load_pair(ocloud, pcloud, dtype, device,
                                     options.peak)
        return evaluate_pair(origin, reconst, options, backend=backend)
