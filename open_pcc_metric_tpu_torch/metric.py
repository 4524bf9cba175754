"""Metric class hierarchy — the classes ``options.transform_options`` builds.

Port of ``open_pcc_metric_tpu/metric.py`` (reference
open_pcc_metric/metric.py:14-485): class names, constructors and ``_key()``
layouts are the reference's, so result tables carry the same labels. The
fused engine (``evaluate._evaluate_pair_fused``) fills each metric's
``value``; the per-metric ``calculate`` bodies of the lazy DAG engine are
not ported yet.

``point_to_plane`` accepts the reference's ``True``/``False`` plus the string
``"pc_error"`` for the NN-normal D2 convention (SURVEY Q3).
"""
from __future__ import annotations

import typing


class AbstractMetric:
    """Base: identity key for memoisation (reference: metric.py:14-29)."""

    value: typing.Any = None

    def _key(self) -> typing.Tuple:
        return (self.__class__.__name__,)

    def __str__(self) -> str:
        return f"{self._key()}: {self.value}"


class PrimaryMetric(AbstractMetric):
    """Reads the cloud pair directly (reference: metric.py:32-38)."""


class SecondaryMetric(AbstractMetric):
    """Computed from other metrics (reference: metric.py:41-50)."""


class DirectionalMetric(AbstractMetric):
    is_left: bool

    def __init__(self, is_left: bool):
        self.is_left = is_left

    def _key(self) -> typing.Tuple:
        return super()._key() + (self.is_left,)


class PointToPlaneable(DirectionalMetric):
    """``point_to_plane``: False | True (reference D2) | "pc_error" (NN-normal D2)."""

    point_to_plane: typing.Union[bool, str]

    def __init__(self, is_left: bool, point_to_plane: typing.Union[bool, str]):
        super().__init__(is_left)
        self.point_to_plane = point_to_plane

    def _key(self) -> typing.Tuple:
        return super()._key() + (self.point_to_plane,)


class _UserPeak(PointToPlaneable):
    """A geometric PSNR with an optional user peak (pc_error --resolution)."""

    def __init__(
        self,
        is_left: bool,
        point_to_plane: typing.Union[bool, str],
        peak: typing.Optional[float] = None,
    ):
        super().__init__(is_left, point_to_plane)
        self.peak = peak

    def _key(self) -> typing.Tuple:
        # Reference key layout unchanged when peak is absent; a user peak
        # must split the memo slot from the OBB-peak variant.
        k = super()._key()
        return k if self.peak is None else k + (self.peak,)


class ColorMetric(DirectionalMetric):
    color_scheme: str

    def __init__(self, is_left: bool, color_scheme: str):
        super().__init__(is_left)
        self.color_scheme = color_scheme

    def _key(self) -> typing.Tuple:
        return super()._key() + (self.color_scheme,)


class MinSqrtDistance(SecondaryMetric):
    """Smallest intra-origin NN distance; first report row (ref metric.py:191-199)."""


class MaxSqrtDistance(SecondaryMetric):
    """Largest intra-origin NN distance; second report row (ref metric.py:202-210)."""


class GeoMSE(SecondaryMetric, PointToPlaneable):
    """sum(sq_errors)/N — the D1/D2 MSE (reference: metric.py:213-228)."""


class GeoPSNR(SecondaryMetric, _UserPeak):
    """10*log10(peak^2 / MSE), peak = max(origin minimal-OBB extent) unless a
    user peak is given (reference: metric.py:231-247, Q4)."""


class ColorMSE(SecondaryMetric, ColorMetric):
    """Per-channel mean squared colour error (reference: metric.py:302-333)."""


class ColorPSNR(SecondaryMetric, ColorMetric):
    """10*log10(peak^2 / ColorMSE) per channel (reference: metric.py:336-350)."""


class GeoHausdorffDistance(SecondaryMetric, PointToPlaneable):
    """max of per-point squared errors (reference: metric.py:353-366)."""


class GeoHausdorffDistancePSNR(SecondaryMetric, _UserPeak):
    """10*log10(MaxSqrtDistance^2 / hausdorff) unless a user peak is given
    (reference: metric.py:369-386, Q4)."""


class ColorHausdorffDistance(SecondaryMetric, ColorMetric):
    """Per-channel max squared colour error (reference: metric.py:389-426)."""


class ColorHausdorffDistancePSNR(SecondaryMetric, ColorMetric):
    """10*log10(peak^2 / ColorHausdorffDistance) per channel."""


class SymmetricMetric(SecondaryMetric):
    """Worse-of-both-directions selection by whole-value L2 norm
    (reference: metric.py:446-485, Q7): ``is_proportional=True`` -> min
    (PSNRs), ``False`` -> max (MSE / Hausdorff)."""

    is_proportional: bool
    metrics: typing.List[DirectionalMetric]

    def __init__(
        self,
        metrics: typing.Sequence[DirectionalMetric],
        is_proportional: bool,
    ):
        if len(metrics) != 2:
            raise ValueError(
                "a symmetric metric wraps exactly two directional metrics, "
                f"got {len(metrics)}"
            )
        if metrics[0].__class__ is not metrics[1].__class__:
            raise ValueError(
                "both directions must use the same metric class; got "
                f"{metrics[0].__class__.__name__} and "
                f"{metrics[1].__class__.__name__}"
            )
        self.metrics = list(metrics)
        self.is_proportional = is_proportional

    def _key(self) -> typing.Tuple:
        return super()._key() + self.metrics[0]._key() + self.metrics[1]._key()
