"""The benchmark's inputs, made from a seed.

A frozen copy of the port's ``datasets.voxel_surface`` and
``degrade_gpcc_like`` and of the binary branch of ``io.write_ply``, so that
a later change to the program cannot change what the benchmark feeds it.
The copies give the same arrays; they find unique rows through one
integer key a row (``_unique_rows``) instead of ``np.unique(axis=0)``,
about three times faster at 800k points, since set-up pays it every run.
``tests/test_portbench_reference.py`` holds them to the port's originals
bit for bit.
"""
from __future__ import annotations

import os
import typing

import numpy as np


def _unique_rows(m: np.ndarray):
    """``np.unique(m, axis=0, return_index=True)`` for rows of small
    non-negative integers (held as floats): the rows sorted
    lexicographically and each one's first occurrence, through one int64
    key a row; the general call where a value does not fit 21 bits."""
    if m.size and (m.min() < 0 or m.max() >= (1 << 21)):
        return np.unique(m, axis=0, return_index=True)
    k = m.astype(np.int64)
    key = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    _, first = np.unique(key, return_index=True)
    return m[first], first


def voxel_surface(n_target: int, grid: int, seed: int):
    """A concave bumpy-sphere surface voxelised to an integer grid:
    (points (N, 3) float64 integer-valued, colours (N, 3) in [0, 1] on
    the 8-bit grid, unit radial normals (N, 3))."""
    rng = np.random.default_rng(seed)
    m = int(n_target * 5)
    v = rng.normal(size=(m, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1.0 + 0.25 * np.sin(3 * v[:, 0] * np.pi) * np.cos(
        2 * v[:, 1] * np.pi
    )
    r = grid * 0.37 * bump
    pts = np.round(v * r[:, None] + grid / 2.0)
    pts, _ = _unique_rows(pts)
    if pts.shape[0] > n_target:
        sel = rng.choice(pts.shape[0], n_target, replace=False)
        sel.sort()
        pts = pts[sel]
    normals = pts - grid / 2.0
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    colors = np.round(255 * (0.5 + 0.5 * np.sin(pts / 64.0))) / 255.0
    return pts, colors, normals


def degrade_gpcc_like(points: np.ndarray, colors: np.ndarray, qp: int,
                      seed: int):
    """Geometry quantised by 2^(qp/6) and re-voxelised (duplicates merged),
    colours perturbed by about qp/2 code levels: a codec's artefacts at
    one rate point, reproducible from the seed."""
    rng = np.random.default_rng(seed + qp)
    step = max(1.0, 2.0 ** (qp / 6.0))
    m, idx = _unique_rows(np.round(points / step))
    q = m * step
    c = colors[idx]
    noise = rng.integers(-qp // 2 - 1, qp // 2 + 2, c.shape) / 255.0
    c = np.clip(np.round((c + noise) * 255.0) / 255.0, 0.0, 1.0)
    return q, c


def write_ply(path: str, points: np.ndarray, colors: np.ndarray,
              normals: typing.Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY: float64 x, y, z, float64 normals when
    given, uchar colours (rounded from [0, 1])."""
    n = points.shape[0]
    fields = [("x", "<f8"), ("y", "<f8"), ("z", "<f8")]
    props = ["property double x", "property double y", "property double z"]
    if normals is not None:
        fields += [("nx", "<f8"), ("ny", "<f8"), ("nz", "<f8")]
        props += [f"property double n{a}" for a in "xyz"]
    fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    props += [f"property uchar {c}" for c in ("red", "green", "blue")]
    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points.T
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals.T
    c8 = np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = c8.T
    header = "\n".join(["ply", "format binary_little_endian 1.0",
                        f"element vertex {n}"] + props + ["end_header", ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


class Frame(typing.NamedTuple):
    """One cloud as its file holds it: colours on the 8-bit grid, normals
    only where the file carries them."""

    tag: str
    points: np.ndarray
    colors: np.ndarray
    normals: typing.Optional[np.ndarray]
    path: str


class Group(typing.NamedTuple):
    """A reference frame and its degraded frames, one per rate point."""

    reference: Frame
    degraded: typing.List[Frame]


def make_groups(config: dict, seed: int, out_dir: str) -> typing.List[Group]:
    """``config["frames"]`` reference frames (seeds ``seed``, ``seed + 1``,
    ...), each degraded at every QP of ``config["qps"]`` with its own seed,
    written as PLY into ``out_dir``. The reference file carries normals when
    ``config["reference_normals"]``; degraded files never do."""
    groups = []
    for f in range(config["frames"]):
        s = seed + f
        pts, col, nrm = voxel_surface(config["points"], config["grid"], s)
        ref = Frame(f"f{f}", pts, col,
                    nrm if config["reference_normals"] else None,
                    os.path.join(out_dir, f"f{f}_reference.ply"))
        write_ply(ref.path, ref.points, ref.colors, ref.normals)
        deg = []
        for qp in config["qps"]:
            q, c = degrade_gpcc_like(pts, col, qp, s)
            fr = Frame(f"f{f}_qp{qp:02d}", q, c, None,
                       os.path.join(out_dir, f"f{f}_qp{qp:02d}.ply"))
            write_ply(fr.path, fr.points, fr.colors)
            deg.append(fr)
        groups.append(Group(ref, deg))
    return groups
