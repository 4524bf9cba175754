"""The 1-NN searches' share of their roofline: the least time the traced
window's 1-NN sweeps could take on this card (``roofline.py``, from the
clouds' sizes and the suite's options alone), over the profiler's time of
the kernels listed here, in %. The kernels no metric lists are reported on
the ``other`` line."""

from portbench import roofline

LAYER = ("1-NN search (ops/nn.py, ops/nn_pruned.py, ops/select.py,"
         " ops/refine.py)")
UNIT = "%"
MOVES = "mpts_per_s"
KERNELS = (
    "refine_nn_kernel",            # K1: probe, extension, tiers
    "refine_nn_straight_kernel",   # K1b: fixed-cap stage 1
    "refine_nn_fused_kernel",      # K1c
    "refine_nn_payload_kernel",    # K6: payload schedule
    "adaptive_refine_kernel",      # K7: adaptive schedule
    "nn_brute_kernel",             # K5: clouds below 65536 rows
    "select_bbox_shared",          # K2a: select prologue
    "select_bbox_recompute",       # K2a, rows above 28672 chunks
    "count_bbox_kernel",           # K2b: certificate counts
    "select_candidates_radix",     # K2c: fixed-cap candidates
    "select_candidates_rounds",    # K2c, rows too wide for shared memory
)
LAYER_KEY = "nn"


def read(run):
    if run.summary is None:
        return None
    peak = roofline.peaks(run.device_name)
    busy = sum(run.summary.kernels.get(k, 0.0) for k in KERNELS)
    if peak is None or busy <= 0:
        return None
    return 100.0 * roofline.bound_seconds(run.sweeps(), LAYER_KEY, peak) / busy
