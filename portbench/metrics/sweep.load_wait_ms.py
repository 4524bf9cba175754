"""How long a sweep's evaluation waited for its prefetched pair: the mean
of the journal's ``stages.load_wait_s`` over the window's records, in ms a
pair (the sweep pipeline, ``batch.run_sweep``)."""

LAYER = "sweep pipeline (batch.py)"
UNIT = "ms/pair"
MOVES = "mpts_per_s"


def read(run):
    waits = [r["stages"]["load_wait_s"] for c in run.calls
             for r in c.records if "stages" in r]
    return sum(waits) / len(waits) * 1e3 if waits else None
