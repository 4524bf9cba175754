"""Metric class hierarchy — the reference's classes, keys and DAG edges.

Port of ``open_pcc_metric_tpu/metric.py`` (reference
open_pcc_metric/metric.py:14-485): class names, constructors, ``_key()``
layouts, dependency edges (``_get_dependencies``) and formulas are the
reference's, so result tables carry the same labels and the lazy DAG
engine (``calculator.MetricCalculator`` over a ``CloudPair``) evaluates the
same graph. The math runs as torch ops on the pair's device tensors:
per-point norms and D2 projections batched, colour transforms unrolled
(``ops/color.py``). Reduced values leave the device as float64 numpy, as
the fused engine gives them, so ``SymmetricMetric``'s norm-based min/max
(SURVEY Q7) is host numpy math. The fused engine
(``evaluate._evaluate_pair_fused``) fills the same classes' ``value``
without calling ``calculate``.

``point_to_plane`` accepts the reference's ``True``/``False`` plus the string
``"pc_error"`` for the NN-normal D2 convention (SURVEY Q3).
"""
from __future__ import annotations

import abc
import typing

import numpy as np
import torch

from .ops.color import get_color_peak, transform_colors
from .ops.fused import stable_sum

if typing.TYPE_CHECKING:
    from .cloud_pair import CloudPair


def _host(value) -> typing.Any:
    """Device tensor, array or scalar -> numpy float64 on the host."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to(torch.float64).cpu().numpy()
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        return np.float64(arr)
    return arr


class AbstractMetric(abc.ABC):
    """Base: identity key for memoisation + abstract calculate
    (reference: metric.py:14-29)."""

    value: typing.Any = None

    def _key(self) -> typing.Tuple:
        return (self.__class__.__name__,)

    @abc.abstractmethod
    def calculate(self, *args, **kwargs) -> None:
        raise NotImplementedError("calculate is not implemented")

    def __str__(self) -> str:
        return f"{self._key()}: {self.value}"


class PrimaryMetric(AbstractMetric):
    """Reads the CloudPair directly (reference: metric.py:32-38)."""

    @abc.abstractmethod
    def calculate(self, cloud_pair: "CloudPair") -> None:
        raise NotImplementedError


class SecondaryMetric(AbstractMetric):
    """Computed from other metrics (reference: metric.py:41-50)."""

    def _get_dependencies(self) -> typing.Dict[str, "AbstractMetric"]:
        return {}

    @abc.abstractmethod
    def calculate(self, **kwargs) -> None:
        raise NotImplementedError


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


# ------------------------------------------------------------------- primary


class PrimaryErrorVector(PrimaryMetric, DirectionalMetric):
    """Per-point error vectors point - NN(point) (reference: metric.py:74-80)."""

    def calculate(self, cloud_pair: "CloudPair") -> None:
        if self.is_left:
            self.value = cloud_pair.get_left_error_vector()
        else:
            self.value = cloud_pair.get_right_error_vector()


class NeighbourDistances(PrimaryMetric, DirectionalMetric):
    """Per-point SQUARED NN distances (reference: metric.py:83-89, Q6)."""

    def calculate(self, cloud_pair: "CloudPair") -> None:
        if self.is_left:
            self.value = cloud_pair.get_left_neighbour_distances()
        else:
            self.value = cloud_pair.get_right_neighbour_distances()


class CloudNormals(PrimaryMetric, DirectionalMetric):
    """Full normals of cloud 0 / cloud 1 (reference: metric.py:92-98)."""

    def calculate(self, cloud_pair: "CloudPair") -> None:
        self.value = cloud_pair.get_cloud_normals(0 if self.is_left else 1)


class NeighbourNormals(PrimaryMetric, DirectionalMetric):
    """Normals of each point's actual NN in the other cloud (pc_error D2 mode;
    no reference analogue — the reference only has the positional quirk, Q3)."""

    def calculate(self, cloud_pair: "CloudPair") -> None:
        self.value = cloud_pair.get_neighbour_normals(0 if self.is_left else 1)


class CloudExtent(PrimaryMetric):
    """Minimal-OBB extent of the ORIGIN cloud (reference: metric.py:101-103)."""

    def calculate(self, cloud_pair: "CloudPair") -> None:
        self.value = _host(cloud_pair.get_extent())


class CloudColors(PrimaryMetric, DirectionalMetric):
    def calculate(self, cloud_pair: "CloudPair") -> None:
        if self.is_left:
            self.value = cloud_pair.get_left_colors()
        else:
            self.value = cloud_pair.get_right_colors()


class NeighbourColors(PrimaryMetric, DirectionalMetric):
    def calculate(self, cloud_pair: "CloudPair") -> None:
        if self.is_left:
            self.value = cloud_pair.get_left_neighbour_colors()
        else:
            self.value = cloud_pair.get_right_neighbour_colors()


class BoundarySqrtDistances(PrimaryMetric):
    """(min, max) of intra-origin NN distances (reference: metric.py:182-188)."""

    def calculate(self, cloud_pair: "CloudPair") -> None:
        inner = cloud_pair.get_boundary_sqrt_distances()
        self.value = (_host(inner.amin()), _host(inner.amax()))


# ----------------------------------------------------------------- secondary


class ErrorVector(SecondaryMetric, PointToPlaneable):
    """p2point: per-point L2 norm of the error vector; p2plane: projection of
    the error vector onto normals (reference: metric.py:124-153)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        deps: typing.Dict[str, AbstractMetric] = {
            "primary_error_vector": PrimaryErrorVector(is_left=self.is_left)
        }
        if self.point_to_plane == "pc_error":
            deps["cloud_normals"] = NeighbourNormals(is_left=self.is_left)
        elif self.point_to_plane:
            # Reference quirk Q3: the OPPOSITE cloud's normals, positionally.
            deps["cloud_normals"] = CloudNormals(is_left=not self.is_left)
        return deps

    def calculate(
        self,
        primary_error_vector: PrimaryErrorVector,
        cloud_normals: typing.Optional[AbstractMetric] = None,
    ) -> None:
        err = primary_error_vector.value
        if not self.point_to_plane:
            self.value = torch.linalg.vector_norm(err, dim=1)
            return
        normals = cloud_normals.value
        if self.point_to_plane != "pc_error":  # positional: first n_iter rows
            if normals.shape[0] < err.shape[0]:
                raise IndexError(
                    "reference D2 mode requires n_iter <= n_other "
                    f"(got {err.shape[0]} > {normals.shape[0]}); "
                    "use point_to_plane='pc_error'"
                )
            normals = normals[: err.shape[0]]
        self.value = (err * normals).sum(dim=1)


class EuclideanDistance(SecondaryMetric, PointToPlaneable):
    """p2point: squared NN distances passthrough; p2plane: squared projection
    (reference: metric.py:156-179 — always per-point SQUARED errors)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        if not self.point_to_plane:
            return {
                "neighbour_distances": NeighbourDistances(is_left=self.is_left)
            }
        return {
            "error_vector": ErrorVector(
                is_left=self.is_left, point_to_plane=self.point_to_plane
            )
        }

    def calculate(
        self,
        neighbour_distances: typing.Optional[NeighbourDistances] = None,
        error_vector: typing.Optional[ErrorVector] = None,
    ) -> None:
        if not self.point_to_plane:
            self.value = neighbour_distances.value
            return
        self.value = error_vector.value ** 2


class MinSqrtDistance(SecondaryMetric):
    """Smallest intra-origin NN distance; first report row (ref metric.py:191-199)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {"boundary": BoundarySqrtDistances()}

    def calculate(self, boundary: BoundarySqrtDistances) -> None:
        self.value = boundary.value[0]


class MaxSqrtDistance(SecondaryMetric):
    """Largest intra-origin NN distance; second report row (ref metric.py:202-210)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {"boundary": BoundarySqrtDistances()}

    def calculate(self, boundary: BoundarySqrtDistances) -> None:
        self.value = boundary.value[1]


class GeoMSE(SecondaryMetric, PointToPlaneable):
    """sum(sq_errors)/N — the D1/D2 MSE (reference: metric.py:213-228)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {
            "euclidean_distance": EuclideanDistance(
                is_left=self.is_left, point_to_plane=self.point_to_plane
            )
        }

    def calculate(self, euclidean_distance: EuclideanDistance) -> None:
        errors = euclidean_distance.value
        self.value = _host(stable_sum(errors)) / errors.shape[0]


class GeoPSNR(SecondaryMetric, _UserPeak):
    """10*log10(peak^2 / MSE), peak = max(origin minimal-OBB extent) unless a
    user peak is given (reference: metric.py:231-247, Q4)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        deps: typing.Dict[str, AbstractMetric] = {
            "geo_mse": GeoMSE(
                is_left=self.is_left, point_to_plane=self.point_to_plane
            ),
        }
        if self.peak is None:
            deps["cloud_extent"] = CloudExtent()
        return deps

    def calculate(
        self,
        geo_mse: GeoMSE,
        cloud_extent: typing.Optional[CloudExtent] = None,
    ) -> None:
        peak = self.peak if self.peak is not None \
            else np.max(cloud_extent.value)
        with np.errstate(divide="ignore"):
            self.value = np.float64(10 * np.log10(peak**2 / geo_mse.value))


class ColorMSE(SecondaryMetric, ColorMetric):
    """Per-channel mean squared colour error after the scheme transform
    (reference: metric.py:302-333)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {
            "origin_cloud_colors": CloudColors(is_left=self.is_left),
            "neighbour_cloud_colors": NeighbourColors(is_left=self.is_left),
        }

    def calculate(
        self,
        origin_cloud_colors: CloudColors,
        neighbour_cloud_colors: NeighbourColors,
    ) -> None:
        diff = _color_diff(self.color_scheme, origin_cloud_colors,
                           neighbour_cloud_colors)
        self.value = _host(stable_sum(diff**2)) / diff.shape[0]


class ColorPSNR(SecondaryMetric, ColorMetric):
    """10*log10(peak^2 / ColorMSE) per channel; rgb peak is 255.0 even though
    colours live in [0,1] (reference: metric.py:336-350, Q5)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {
            "color_mse": ColorMSE(
                is_left=self.is_left, color_scheme=self.color_scheme
            ),
        }

    def calculate(self, color_mse: ColorMSE) -> None:
        peak = get_color_peak(self.color_scheme)
        with np.errstate(divide="ignore"):
            self.value = 10 * np.log10(peak**2 / color_mse.value)


class GeoHausdorffDistance(SecondaryMetric, PointToPlaneable):
    """max of per-point squared errors (reference: metric.py:353-366)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {
            "euclidean_distance": EuclideanDistance(
                is_left=self.is_left, point_to_plane=self.point_to_plane
            )
        }

    def calculate(self, euclidean_distance: EuclideanDistance) -> None:
        self.value = _host(euclidean_distance.value.amax(dim=0))


class GeoHausdorffDistancePSNR(SecondaryMetric, _UserPeak):
    """10*log10(MaxSqrtDistance^2 / hausdorff) unless a user peak is given
    (reference: metric.py:369-386, Q4)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        deps: typing.Dict[str, AbstractMetric] = {
            "hausdorff_distance": GeoHausdorffDistance(
                is_left=self.is_left, point_to_plane=self.point_to_plane
            ),
        }
        if self.peak is None:
            deps["max_sqrt"] = MaxSqrtDistance()
        return deps

    def calculate(
        self,
        hausdorff_distance: GeoHausdorffDistance,
        max_sqrt: typing.Optional[MaxSqrtDistance] = None,
    ) -> None:
        peak = self.peak if self.peak is not None else max_sqrt.value
        with np.errstate(divide="ignore"):
            self.value = np.float64(
                10 * np.log10(peak**2 / hausdorff_distance.value)
            )


def _color_diff(scheme, origin_cloud_colors, neighbour_cloud_colors):
    """Transformed origin colours minus transformed neighbour colours."""
    return (transform_colors(origin_cloud_colors.value, "rgb", scheme)
            - transform_colors(neighbour_cloud_colors.value, "rgb", scheme))


class ColorHausdorffDistance(SecondaryMetric, ColorMetric):
    """Per-channel max squared colour error; rgb diffs pre-scaled x255 — the
    reference's own quirk reproduced as-is (reference: metric.py:389-426,
    Q5)."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {
            "origin_cloud_colors": CloudColors(is_left=self.is_left),
            "neighbour_cloud_colors": NeighbourColors(is_left=self.is_left),
        }

    def calculate(
        self,
        origin_cloud_colors: CloudColors,
        neighbour_cloud_colors: NeighbourColors,
    ) -> None:
        diff = _color_diff(self.color_scheme, origin_cloud_colors,
                           neighbour_cloud_colors)
        if self.color_scheme == "rgb":
            diff = 255.0 * diff
        self.value = _host((diff**2).amax(dim=0))


class ColorHausdorffDistancePSNR(SecondaryMetric, ColorMetric):
    """10*log10(peak^2 / ColorHausdorffDistance) per channel."""

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {
            "hausdorff_distance": ColorHausdorffDistance(
                is_left=self.is_left, color_scheme=self.color_scheme
            ),
        }

    def calculate(self, hausdorff_distance: ColorHausdorffDistance) -> None:
        peak = get_color_peak(self.color_scheme)
        with np.errstate(divide="ignore"):
            self.value = 10 * np.log10(peak**2 / hausdorff_distance.value)


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

    def _get_dependencies(self) -> typing.Dict[str, AbstractMetric]:
        return {"lmetric": self.metrics[0], "rmetric": self.metrics[1]}

    def _key(self) -> typing.Tuple:
        return super()._key() + self.metrics[0]._key() + self.metrics[1]._key()

    def calculate(self, lmetric: AbstractMetric, rmetric: AbstractMetric) -> None:
        values = [_host(m.value) for m in (lmetric, rmetric)]
        if self.is_proportional:
            self.value = min(values, key=np.linalg.norm)
        else:
            self.value = max(values, key=np.linalg.norm)
