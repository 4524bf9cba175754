"""Memoised metric-DAG evaluation and the result container.

Port of ``open_pcc_metric_tpu/calculator.py`` (reference
open_pcc_metric/calculator.py:15-108):

  * ``MetricCalculator`` evaluates a metric list over one ``CloudPair``,
    depth first through ``_get_dependencies``, memoised on ``_key()`` so
    the left/right/dependency diamond computes each node once. The memo is
    an INSTANCE attribute: the reference's class-level one leaks results
    across cloud pairs in one process (SURVEY Q1).
  * ``CalculateResult``: the same four columns — label, is_left,
    point-to-plane, value — printed as a text table or as CSV, without
    pandas. The CSV matches ``pandas.DataFrame.to_csv`` of the JAX
    package's table (a leading row-index column).
"""
from __future__ import annotations

import csv
import io
import typing

from .metric import AbstractMetric, PrimaryMetric, SecondaryMetric, \
    SymmetricMetric

if typing.TYPE_CHECKING:
    from .cloud_pair import CloudPair

COLUMNS = ("label", "is_left", "point-to-plane", "value")


class CalculateResult:
    _metrics: typing.List[AbstractMetric]

    def __init__(self, metrics: typing.List[AbstractMetric]):
        self._metrics = metrics

    def as_dict(self) -> typing.Dict[typing.Tuple, typing.Any]:
        return {metric._key(): metric.value for metric in self._metrics}

    def rows(self) -> typing.List[typing.Tuple[str, str, str, str]]:
        """One (label, is_left, point-to-plane, value) row per metric, as
        the strings the reference table shows."""
        out = []
        for metric in self._metrics:
            label = metric.__class__.__name__
            if isinstance(metric, SymmetricMetric):
                label = metric.metrics[0].__class__.__name__ + "(symmetric)"
            out.append((
                label,
                str(getattr(metric, "is_left", "")),
                str(getattr(metric, "point_to_plane", "")),
                str(metric.value),
            ))
        return out

    def to_csv(self) -> str:
        buf = io.StringIO()
        writer = csv.writer(buf, lineterminator="\n")
        writer.writerow(("",) + COLUMNS)
        for i, row in enumerate(self.rows()):
            writer.writerow((i,) + row)
        return buf.getvalue()

    def to_string(self) -> str:
        table = [("",) + COLUMNS] + [
            (str(i),) + row for i, row in enumerate(self.rows())]
        widths = [max(len(r[c]) for r in table) for c in range(len(table[0]))]
        lines = []
        for r in table:
            cells = [r[0].ljust(widths[0])]
            cells += [v.rjust(w) for v, w in zip(r[1:], widths[1:])]
            lines.append("  ".join(cells))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.to_string()


class MetricCalculator:
    _cloud_pair: "CloudPair"
    _calculated_metrics: typing.Dict[typing.Tuple, AbstractMetric]

    def __init__(self, cloud_pair: "CloudPair"):
        self._cloud_pair = cloud_pair
        self._calculated_metrics = {}

    def _metric_recursive_calculate(
        self, metric: AbstractMetric
    ) -> AbstractMetric:
        key = metric._key()
        if key in self._calculated_metrics:
            return self._calculated_metrics[key]

        if isinstance(metric, PrimaryMetric):
            metric.calculate(self._cloud_pair)
        elif isinstance(metric, SecondaryMetric):
            deps = {
                name: self._metric_recursive_calculate(dep)
                for name, dep in metric._get_dependencies().items()
            }
            metric.calculate(**deps)
        else:
            raise RuntimeError(
                f"cannot evaluate {metric.__class__.__name__}: every metric "
                "must derive from PrimaryMetric or SecondaryMetric"
            )
        self._calculated_metrics[key] = metric
        return metric

    def calculate(
        self, metrics_list: typing.List[AbstractMetric]
    ) -> CalculateResult:
        return CalculateResult(
            [self._metric_recursive_calculate(m) for m in metrics_list]
        )
