"""Host time of loading the window's clouds: the port's ``pcc.load`` spans
(the file's parse, the upload and the wait for it) on every thread (the
CLI loads on the calling thread, the sweep on its prefetch threads),
summed and divided by the window's pairs, in ms a pair."""

from portbench import spans

LAYER = "CLI / API, file IO (evaluate.py, io/loaders.py, cloud.py)"
UNIT = "ms/pair"
MOVES = "mpts_per_s"


def read(run):
    t = spans.totals(run)
    if t is None:
        return None
    return spans.seconds(t, "pcc.load") / len(run.pairs) * 1e3
