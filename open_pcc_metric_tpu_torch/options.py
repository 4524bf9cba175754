"""Options -> concrete metric plan expansion.

Port of ``open_pcc_metric_tpu/options.py`` (reference
open_pcc_metric/options.py:16-174): the same 8 base metrics, +6 colour,
+6 point-to-plane, +6 Hausdorff, +6 Hausdorff x p2plane, in the reference's
exact order (result-table row order matches).

Extensions beyond the reference CLI (available in the reference *library* but
not reachable from its CLI — SURVEY §2.3 "not instantiable"):
  * ``color`` may be "yuv" (reference CLI restricts to rgb/ycc, handler.py:20),
  * ``color_hausdorff=True`` adds ColorHausdorffDistance(+PSNR) rows,
  * ``d2_mode="pc_error"`` switches D2 to the NN-normal convention (Q3).
"""
from __future__ import annotations

import typing

from .metric import (
    AbstractMetric,
    ColorHausdorffDistance,
    ColorHausdorffDistancePSNR,
    ColorMSE,
    ColorPSNR,
    GeoHausdorffDistance,
    GeoHausdorffDistancePSNR,
    GeoMSE,
    GeoPSNR,
    MaxSqrtDistance,
    MinSqrtDistance,
    SymmetricMetric,
)


class CalculateOptions:
    """Plain options holder (reference: options.py:16-29)."""

    color: typing.Optional[str]
    hausdorff: bool
    point_to_plane: bool
    color_hausdorff: bool
    d2_mode: str
    peak: typing.Optional[float]

    def __init__(
        self,
        color: typing.Optional[str] = None,
        hausdorff: bool = False,
        point_to_plane: bool = False,
        color_hausdorff: bool = False,
        d2_mode: str = "reference",
        peak: typing.Optional[float] = None,
    ):
        if color is not None and color not in ("rgb", "ycc", "yuv"):
            raise ValueError(f"unknown color scheme {color!r}")
        if d2_mode not in ("reference", "pc_error"):
            raise ValueError(f"unknown d2_mode {d2_mode!r}")
        if peak is not None and not peak > 0:
            raise ValueError(f"peak must be positive, got {peak!r}")
        self.color = color
        self.hausdorff = hausdorff
        self.point_to_plane = point_to_plane
        self.color_hausdorff = color_hausdorff
        self.d2_mode = d2_mode
        # pc_error's --resolution convention: a user-supplied signal peak for
        # every geometric PSNR (D1/D2 and Hausdorff), instead of the
        # reference's OBB-extent / intra-NN-distance peaks (SURVEY Q4).
        self.peak = float(peak) if peak is not None else None


def _sym(cls, is_proportional, **kw) -> SymmetricMetric:
    return SymmetricMetric(
        metrics=(cls(is_left=True, **kw), cls(is_left=False, **kw)),
        is_proportional=is_proportional,
    )


def transform_options(
    options: CalculateOptions,
) -> typing.List[AbstractMetric]:
    """Expand options into the ordered metric list (reference: options.py:32-174)."""
    p2p: typing.Union[bool, str] = (
        "pc_error" if options.d2_mode == "pc_error" else True
    )
    pk = options.peak

    metrics: typing.List[AbstractMetric] = [
        MinSqrtDistance(),
        MaxSqrtDistance(),
        GeoMSE(is_left=True, point_to_plane=False),
        GeoMSE(is_left=False, point_to_plane=False),
        _sym(GeoMSE, False, point_to_plane=False),
        GeoPSNR(is_left=True, point_to_plane=False, peak=pk),
        GeoPSNR(is_left=False, point_to_plane=False, peak=pk),
        _sym(GeoPSNR, True, point_to_plane=False, peak=pk),
    ]

    if options.color is not None:
        c = options.color
        metrics += [
            ColorMSE(is_left=True, color_scheme=c),
            ColorMSE(is_left=False, color_scheme=c),
            _sym(ColorMSE, False, color_scheme=c),
            ColorPSNR(is_left=True, color_scheme=c),
            ColorPSNR(is_left=False, color_scheme=c),
            _sym(ColorPSNR, True, color_scheme=c),
        ]

    if options.point_to_plane:
        metrics += [
            GeoMSE(is_left=True, point_to_plane=p2p),
            GeoMSE(is_left=False, point_to_plane=p2p),
            _sym(GeoMSE, False, point_to_plane=p2p),
            GeoPSNR(is_left=True, point_to_plane=p2p, peak=pk),
            GeoPSNR(is_left=False, point_to_plane=p2p, peak=pk),
            _sym(GeoPSNR, True, point_to_plane=p2p, peak=pk),
        ]

    if options.hausdorff:
        metrics += [
            GeoHausdorffDistance(is_left=True, point_to_plane=False),
            GeoHausdorffDistance(is_left=False, point_to_plane=False),
            _sym(GeoHausdorffDistance, False, point_to_plane=False),
            GeoHausdorffDistancePSNR(is_left=True, point_to_plane=False,
                                     peak=pk),
            GeoHausdorffDistancePSNR(is_left=False, point_to_plane=False,
                                     peak=pk),
            _sym(GeoHausdorffDistancePSNR, True, point_to_plane=False,
                 peak=pk),
        ]

    if options.hausdorff and options.point_to_plane:
        # Reference order quirk: the four directional rows precede the two
        # symmetric rows in this block (reference: options.py:140-172).
        metrics += [
            GeoHausdorffDistance(is_left=True, point_to_plane=p2p),
            GeoHausdorffDistance(is_left=False, point_to_plane=p2p),
            GeoHausdorffDistancePSNR(is_left=True, point_to_plane=p2p,
                                     peak=pk),
            GeoHausdorffDistancePSNR(is_left=False, point_to_plane=p2p,
                                     peak=pk),
            _sym(GeoHausdorffDistance, False, point_to_plane=p2p),
            _sym(GeoHausdorffDistancePSNR, True, point_to_plane=p2p, peak=pk),
        ]

    if options.color is not None and options.color_hausdorff:
        c = options.color
        metrics += [
            ColorHausdorffDistance(is_left=True, color_scheme=c),
            ColorHausdorffDistance(is_left=False, color_scheme=c),
            _sym(ColorHausdorffDistance, False, color_scheme=c),
            ColorHausdorffDistancePSNR(is_left=True, color_scheme=c),
            ColorHausdorffDistancePSNR(is_left=False, color_scheme=c),
            _sym(ColorHausdorffDistancePSNR, True, color_scheme=c),
        ]

    return metrics
