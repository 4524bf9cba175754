"""What decides ``correct``: every table the window produced, entry by
entry, against the float64 reference on the same generated clouds, as a
cloud of the configuration's ``dtype`` holds them (the program reads the
files into float32; the reference rounds the same arrays itself).

Each entry's gap is taken in dB: a PSNR's difference, and for the other
entries the PSNR difference they would make, ``|10 log10(got / want)|``
for the squared ones (MSEs, Hausdorff distances) and twice that for the
intra-origin distances ``min_sqrt`` and ``max_sqrt``. Three numbers are
compared, each the widest gap of one part of the table over every table,
with its limit from ``limits/<cell>.json``:

- ``d1_db``: the point-to-point entries and the intra-origin distances
  (the 1-NN sweeps, the peak);
- ``d2_db``: the point-to-plane entries (the sweeps and the normals);
- ``color_db``: the colour entries, each channel (the sweeps' neighbours
  and the colour transform);

and ``failed``, the tables that never came (the call raised), lack an
entry the reference has, or read over a limit, with the limit 0. The
same pair gives the same table every time it is evaluated, so the
reference is worked out once a distinct pair; to keep it shorter than the
window, only a sample of ``judged_pairs`` distinct pairs is judged: the
largest degraded frame of the first original (the longest request) and
others drawn from the seed. Every table of a judged pair is compared.
"""
from __future__ import annotations

import typing

import numpy as np

from .reference import obb, oracle

class Verdict(typing.NamedTuple):
    correct: bool
    bad: typing.Set[int]  # indices into run.pairs: raised, incomplete or over a limit
    judged: int  # distinct pairs the reference worked out
    checks: typing.Dict[str, typing.Dict[str, float]]


def as_stored(frame, dtype: str):
    """The frame's arrays as a cloud of the configuration's ``dtype``
    holds them (the program's input), back in float64."""
    def cast(x):
        return None if x is None else x.astype(dtype).astype(np.float64)

    return frame._replace(points=cast(frame.points),
                          colors=cast(frame.colors),
                          normals=cast(frame.normals))


def reference_tables(groups, opts: dict, keys: typing.Iterable[str],
                     precisions=("float64",), reference_normals=True,
                     dtype: str = "float32", workers: int = -1):
    """{precision: {degraded tag: table}} for the pairs named by ``keys``
    (``Group`` list from ``data.generate``), on the clouds as ``dtype``
    holds them. The origin's own 1-NN and its OBB extent are worked out
    once a group."""
    keys = set(keys)
    out = {p: {} for p in precisions}
    for g in groups:
        todo = [as_stored(f, dtype) for f in g.degraded if f.tag in keys]
        if not todo:
            continue
        ref = as_stored(g.reference, dtype)
        for p in precisions:
            ar = oracle.Arith.of(p)
            _, d_self = oracle.nn(ref.points, ref.points, exclude_self=True,
                                  workers=workers, ar=ar)
            extent = None
            if opts.get("peak") is None:
                extent = obb.minimal_obb_extent(ref.points, ar.mul, ar.dtype)
            for f in todo:
                s = oracle.searches(ref.points, f.points, d_self, workers, p)
                out[p][f.tag] = oracle.table(
                    ref.points, f.points, ref.colors, f.colors,
                    ref.normals if reference_normals else None, None, opts,
                    s, p, extent, workers)
    return out


PARTS = ("d1_db", "d2_db", "color_db")


def part(key: str) -> str:
    if key.startswith("d2_"):
        return "d2_db"
    if key.startswith("color_"):
        return "color_db"
    return "d1_db"


def entry_gap(key: str, got, want) -> float:
    """One entry's gap in dB (``inf`` where one side is missing, zero or
    not finite and the other is not)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    with np.errstate(divide="ignore", invalid="ignore"):
        if "psnr" in key:
            gap = np.abs(got - want)
        else:
            scale = 20.0 if key in ("min_sqrt", "max_sqrt") else 10.0
            gap = scale * np.abs(np.log10(got / want))
    gap = np.where(got == want, 0.0, gap)
    return float(np.max(np.where(np.isnan(gap), np.inf, gap)))


def gaps(program: dict, reference: dict) -> typing.Dict[str, float]:
    """The compared numbers for one table."""
    out = dict.fromkeys(PARTS, 0.0)
    for key, want in reference.items():
        g = entry_gap(key, program[key], want) if key in program \
            else float("inf")
        out[part(key)] = max(out[part(key)], g)
    return out


def sample(run, count: int) -> typing.Set[str]:
    """The distinct pairs to judge: the first original's largest degraded
    frame, then others of the window's pairs drawn from the seed."""
    keys = sorted({p.key for p in run.pairs if p.table is not None})
    if not keys:
        return set()
    first = max(run.groups[0].degraded, key=lambda f: f.points.shape[0]).tag
    out = {first} if first in keys else set()
    rest = [k for k in keys if k not in out]
    rng = np.random.default_rng(run.seed)
    take = max(0, min(count - len(out), len(rest)))
    out.update(rest[i] for i in rng.choice(len(rest), take, replace=False))
    return out


def judge(run, limits: dict, workers: int = -1) -> Verdict:
    cfg = run.config
    pairs = run.pairs
    judged = sample(run, limits["judged_pairs"])
    tables = reference_tables(
        run.groups, cfg["options"], judged,
        reference_normals=cfg["reference_normals"], dtype=cfg["dtype"],
        workers=workers)["float64"]
    worst = dict.fromkeys(PARTS, 0.0)
    bad = set()
    for i, p in enumerate(pairs):
        if p.table is None:
            bad.add(i)
            continue
        if p.key not in tables:
            continue
        g = gaps(p.table, tables[p.key])
        for k in worst:
            worst[k] = max(worst[k], g[k])
        if any(not g[k] <= limits[k] for k in worst):
            bad.add(i)
    # JSON has no infinity: a missing or non-finite entry reads as the
    # largest float.
    checks = {k: {"value": v if np.isfinite(v) else np.finfo(float).max,
                  "limit": limits[k]} for k, v in worst.items()}
    checks["failed"] = {"value": len(bad), "limit": 0}
    correct = len(bad) < len(pairs) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return Verdict(correct, bad, len(tables), checks)
