"""One ``evaluate.evaluate_files`` call a pair, as the CLI makes one: both
files parsed and uploaded, the missing normals estimated, the sweeps run
and, with no peak given, the reference's minimal OBB found on the host.

The pairs take turns in (rate point, reference) order, so consecutive
calls alternate references. In the traced run a span of the benchmark's
own times each call of the port's OBB entry (``obb``).
"""
from __future__ import annotations

import time

from portbench.harness import Call, Pair

_GEO = {"GeoMSE": "mse", "GeoPSNR": "psnr",
        "GeoHausdorffDistance": "hausdorff",
        "GeoHausdorffDistancePSNR": "hausdorff_psnr"}
_COLOR = {"ColorMSE": "color_mse", "ColorPSNR": "color_psnr",
          "ColorHausdorffDistance": "color_hausdorff",
          "ColorHausdorffDistancePSNR": "color_hausdorff_psnr"}


def _directional(key: tuple) -> str:
    name, side = key[0], "left" if key[1] else "right"
    if name in _COLOR:
        return f"{_COLOR[name]}_{side}"
    return f"{'d2' if key[2] else 'geo'}_{_GEO[name]}_{side}"


def table_of(result) -> dict:
    """The CLI's table (``CalculateResult``) under the fused evaluation's
    entry names."""
    out = {}
    for key, value in result.as_dict().items():
        if key[0] == "MinSqrtDistance":
            out["min_sqrt"] = value
        elif key[0] == "MaxSqrtDistance":
            out["max_sqrt"] = value
        elif key[0] == "SymmetricMetric":
            out[_directional(key[1:]).rsplit("_", 1)[0] + "_sym"] = value
        else:
            out[_directional(key)] = value
    return out


class Driver:
    def __init__(self, config, traffic, groups, device, work_dir):
        from open_pcc_metric_tpu_torch.options import CalculateOptions

        o = config["options"]
        self.options = CalculateOptions(
            color=o["color"], hausdorff=o["hausdorff"],
            point_to_plane=o["point_to_plane"], d2_mode=o["d2_mode"],
            peak=o["peak"])
        self.dtype, self.device = config["dtype"], device
        self.pairs = [(g.reference, g.degraded[q])
                      for q in range(len(groups[0].degraded)) for g in groups]
        self.turn = 0
        self._obb = None

    def _call(self, i: int) -> Call:
        from open_pcc_metric_tpu_torch.evaluate import evaluate_files

        ref, deg = self.pairs[i]
        table = error = None
        t0 = time.perf_counter()
        try:
            table = table_of(evaluate_files(
                ref.path, deg.path, self.options, self.dtype,
                device=self.device))
        except Exception as e:  # a call that raises is a failed pair
            error = f"{type(e).__name__}: {e}"
        wall = time.perf_counter() - t0
        return Call(wall, [Pair(deg.tag, ref.points.shape[0],
                                deg.points.shape[0], wall, table, error,
                                True)], [])

    def warm_up(self) -> None:
        for i in range(len(self.pairs)):
            self._call(i)

    def step(self) -> Call:
        i = self.turn % len(self.pairs)
        self.turn += 1
        return self._call(i)

    def install_spans(self, spans) -> None:
        """Time each call of ``ops.obb.minimal_obb_extent``, which
        ``Cloud.get_obb_extent`` looks up at every call, on whichever
        thread runs it."""
        from open_pcc_metric_tpu_torch.ops import obb

        original = self._obb = obb.minimal_obb_extent

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                spans.add("obb", time.perf_counter() - t0)

        obb.minimal_obb_extent = timed

    def remove_spans(self) -> None:
        from open_pcc_metric_tpu_torch.ops import obb

        if self._obb is not None:
            obb.minimal_obb_extent, self._obb = self._obb, None

    def close(self) -> None:
        self.pairs = []
