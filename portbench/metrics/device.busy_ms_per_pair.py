"""Device time a table takes: the union of every device-side interval of
the traced window (kernels, copies, sets) over the window's pairs, in ms
a pair. Steadier than the end-to-end rate, which the host's speed moves:
the device's work per pair does not change with it."""

LAYER = "device"
UNIT = "ms/pair"
MOVES = "mpts_per_s"


def read(run):
    s = run.summary
    if s is None or s.busy_s <= 0 or not run.pairs:
        return None
    return s.busy_s / len(run.pairs) * 1e3
