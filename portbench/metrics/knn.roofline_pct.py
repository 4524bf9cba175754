"""The normal estimation's share of its roofline: the least time the
traced window's 30-NN estimations could take on this card (``roofline.py``,
from the clouds' sizes alone), over the profiler's time of the kernels
listed here, in %."""

from portbench import roofline

LAYER = ("normal estimation (ops/normals.py, ops/knn_pruned.py,"
         " ops/eigh3.py)")
UNIT = "%"
MOVES = "mpts_per_s"
KERNELS = (
    "refine_knn_kernel",           # K3: probe, extension, tiers
    "refine_knn_straight_kernel",  # K3b: fixed-cap stage 1
    "knn_moments_kernel",          # K4: moment sums
)
LAYER_KEY = "knn"


def read(run):
    if run.summary is None:
        return None
    peak = roofline.peaks(run.device_name)
    busy = sum(run.summary.kernels.get(k, 0.0) for k in KERNELS)
    if peak is None or busy <= 0:
        return None
    return 100.0 * roofline.bound_seconds(run.sweeps(), LAYER_KEY, peak) / busy
