"""Host time of the minimal-OBB peak: the benchmark's own span around each
call of the port's ``ops.obb.minimal_obb_extent`` (reached through
``Cloud.get_obb_extent``, on the thread the fused evaluation starts beside
its device work), summed over the traced window and divided by its pairs,
in ms a pair."""

LAYER = "host OBB peak (ops/obb.py)"
UNIT = "ms/pair"
MOVES = "pair_ms_p90"


def read(run):
    spans = run.spans.seconds.get("obb")
    if not spans or not run.pairs:
        return None
    return sum(spans) / len(run.pairs) * 1e3
