"""Points scored a second: the sum of (origin + reconstruction) points over
every table of the window that came and was judged right, over the
window's seconds (the window ends when the call running at its deadline
returns)."""

UNIT = "Mpts/s"


def read(run):
    points = sum(p.n_a + p.n_b for i, p in enumerate(run.pairs)
                 if p.table is not None and i not in run.bad)
    return points / run.window_s / 1e6
