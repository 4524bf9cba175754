"""Share of the window's loads decoded on the card: the port's
``pcc.decode.device`` spans (one a PLY whose raw records were split by the
card's kernel) over its ``pcc.parse`` spans (one a load), on every thread
(the CLI loads on the calling thread, the sweep on its prefetch threads).
1.0 where every load is decoded on the card; None where no load was, as in
a port without that span."""

from portbench import spans

LAYER = "CLI / API, file IO (evaluate.py, io/loaders.py, cloud.py)"
UNIT = "loads/load"
MOVES = "mpts_per_s"


def read(run):
    t = spans.totals(run)
    if t is None or "pcc.decode.device" not in t:
        return None
    loads = spans.calls(t, "pcc.parse")
    return spans.calls(t, "pcc.decode.device") / loads if loads else None
