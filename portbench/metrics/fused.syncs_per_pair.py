"""Host syncs a pair: the port's ``pcc.readback`` spans (one a read of a
device value back to the host, on any thread) in the window, over its
pairs."""

from portbench import spans

LAYER = "fused evaluation (ops/fused.py)"
UNIT = "syncs/pair"
MOVES = "mpts_per_s"


def read(run):
    t = spans.totals(run)
    if t is None:
        return None
    return spans.calls(t, "pcc.readback") / len(run.pairs)
