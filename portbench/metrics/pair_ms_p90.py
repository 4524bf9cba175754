"""The 90th percentile of the wall time of every call in the window, from
the call's start to its table on the host (linear interpolation between
the two nearest ranks). Calls that raise count with their time."""

import numpy as np

UNIT = "ms"


def read(run):
    walls = [c.wall_s for c in run.calls]
    return float(np.percentile(walls, 90)) * 1e3 if walls else None
