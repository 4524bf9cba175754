"""Host time the fused evaluation spends issuing a pair's device work: the
port's ``pcc.evaluate`` spans on the thread that drives the window, less
the ``pcc.readback`` (waits for the card's results) and ``pcc.obb_wait``
(waits for the OBB thread) inside them, summed and divided by the
window's pairs, in ms a pair."""

from portbench import spans

LAYER = "fused evaluation (ops/fused.py)"
UNIT = "ms/pair"
MOVES = "mpts_per_s"


def read(run):
    main = spans.main_thread()
    t = spans.totals(run, thread=main)
    if t is None or "pcc.evaluate" not in t:
        return None
    waits = spans.totals(run, thread=main, within="pcc.evaluate")
    host = (t["pcc.evaluate"].seconds - spans.seconds(waits, "pcc.readback")
            - spans.seconds(waits, "pcc.obb_wait"))
    return host / len(run.pairs) * 1e3
