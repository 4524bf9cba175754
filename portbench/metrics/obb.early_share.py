"""How often the host OBB peak's hull starts while the origin's file is
read: the port's ``pcc.obb.early`` spans on the thread that drives the
window (one a hull started as the origin's points were parsed), over the
window's pairs. 1.0 where every call starts its hull at load; None where
no call did, as in a port without that span."""

from portbench import spans

LAYER = "host OBB peak (ops/obb.py)"
UNIT = "hulls/pair"
MOVES = "pair_ms_p90"


def read(run):
    t = spans.totals(run, thread=spans.main_thread())
    if t is None or "pcc.obb.early" not in t:
        return None
    return spans.calls(t, "pcc.obb.early") / len(run.pairs)
