"""The least device time a pair's searches could take, from its inputs.

The work is counted from the clouds' sizes and the suite's options alone,
never from the program's candidate lists, tiles or launches, so a change to
a schedule cannot make it stale:

- a 1-NN sweep of ``nq`` queries against ``ns`` points: 9 operations a
  query (one difference, square and add a coordinate for its nearest
  point); its bytes are both clouds' float32 coordinates read once and each
  query's distance and index (4 + 4 bytes) written once;
- a normal estimation of ``n`` points: 9 operations for each of the 30
  (query, neighbour) pairs and 16 a member for the moments; its bytes are
  the coordinates read once and each normal (3 float32) written once.

A sweep's bound is the larger of its operations over the card's float32
peak and its bytes over its memory bandwidth; a layer's bound is the sum
over its sweeps. ``peaks.json`` holds the card's published peaks.
"""
from __future__ import annotations

import json
import os
import typing

K_NORMALS = 30
OPS_PER_PAIR = 9
OPS_PER_MEMBER = 16
COORD_BYTES = 12
NN_OUT_BYTES = 8
NORMAL_BYTES = 12

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


class Sweep(typing.NamedTuple):
    layer: str  # "nn" or "knn"
    n_query: int
    n_search: int
    self_search: bool


def pair_sweeps(n_a: int, n_b: int, opts: dict, a_normals: bool,
                b_normals: bool, self_sweep: bool) -> typing.List[Sweep]:
    """The searches a table of origin ``n_a`` and reconstruction ``n_b``
    points needs: both directions, the origin's own 1-NN when its boundary
    distances are not known yet, and, under point-to-plane, a normal
    estimation of each cloud that has none."""
    out = [Sweep("nn", n_a, n_b, False), Sweep("nn", n_b, n_a, False)]
    if self_sweep:
        out.append(Sweep("nn", n_a, n_a, True))
    if opts.get("point_to_plane"):
        for n, has in ((n_a, a_normals), (n_b, b_normals)):
            if not has:
                out.append(Sweep("knn", n, n, True))
    return out


def ops_and_bytes(s: Sweep) -> typing.Tuple[float, float]:
    read = COORD_BYTES * (s.n_query if s.self_search
                          else s.n_query + s.n_search)
    if s.layer == "nn":
        return OPS_PER_PAIR * s.n_query, read + NN_OUT_BYTES * s.n_query
    members = K_NORMALS * s.n_query
    return ((OPS_PER_PAIR + OPS_PER_MEMBER) * members,
            read + NORMAL_BYTES * s.n_query)


def peaks(device_name: str) -> typing.Optional[dict]:
    """The published peaks of the card named ``device_name``, or None for
    a card the table does not hold."""
    with open(_PEAKS) as f:
        table = json.load(f)
    for key, row in table.items():
        if key in device_name:
            return row
    return None


def bound_seconds(sweeps: typing.Iterable[Sweep], layer: str,
                  peak: dict) -> float:
    total = 0.0
    for s in sweeps:
        if s.layer == layer:
            ops, nbytes = ops_and_bytes(s)
            total += max(ops / peak["fp32_flops"],
                         nbytes / peak["bytes_per_s"])
    return total
