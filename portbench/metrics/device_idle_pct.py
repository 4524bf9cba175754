"""The share of the traced window in which the card runs nothing: one
less the union of every device-side interval of the profiler's trace
(kernels, copies, sets) over the window's length, in %."""

LAYER = "device"
UNIT = "%"
MOVES = "mpts_per_s"


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
