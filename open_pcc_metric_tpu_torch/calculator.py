"""Result container for an evaluated metric list.

Port of ``CalculateResult`` from ``open_pcc_metric_tpu/calculator.py``
(reference open_pcc_metric/calculator.py:27-52): the same four columns —
label, is_left, point-to-plane, value — printed as a text table or as CSV,
without pandas. The CSV matches ``pandas.DataFrame.to_csv`` of the JAX
package's table (a leading row-index column). The memoised DAG calculator
comes with the DAG slice.
"""
from __future__ import annotations

import csv
import io
import typing

from .metric import AbstractMetric, SymmetricMetric

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
