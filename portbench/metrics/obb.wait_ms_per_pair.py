"""The part of the host OBB peak that the device work does not hide: the
port's ``pcc.obb_wait`` spans (the fused evaluation waiting for its OBB
thread), summed over the window and divided by its pairs, in ms a pair."""

from portbench import spans

LAYER = "host OBB peak (ops/obb.py)"
UNIT = "ms/pair"
MOVES = "pair_ms_p90"


def read(run):
    t = spans.totals(run)
    if t is None:
        return None
    return spans.seconds(t, "pcc.obb_wait") / len(run.pairs) * 1e3
