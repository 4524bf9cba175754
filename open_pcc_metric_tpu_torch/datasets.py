"""Synthetic datasets and codec-style degradations for tests, benches, demos.

A copy of the JAX package's ``datasets.py`` (pure numpy), writing through
this package's ``io.write_ply``: reproducible voxelised surfaces shaped like
the published benchmark content (8iVFB-style integer-grid blobs) and
G-PCC-flavoured degradations for rate-sweep workflows. The same seeds give
the same arrays and files as the JAX package's.
"""
from __future__ import annotations

import os
import typing

import numpy as np


def voxel_surface(
    n_target: int = 800_000,
    grid: int = 1024,
    seed: int = 0,
) -> typing.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A concave bumpy-sphere surface voxelised to an integer grid.

    Returns (points (N,3) float64 integer-valued, colors (N,3) in [0,1],
    normals (N,3) unit). Concavity keeps the convex hull small, like real
    scanned humans (a pure sphere would put every voxel on the hull).
    """
    rng = np.random.default_rng(seed)
    m = int(n_target * 5)
    v = rng.normal(size=(m, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1.0 + 0.25 * np.sin(3 * v[:, 0] * np.pi) * np.cos(
        2 * v[:, 1] * np.pi
    )
    r = grid * 0.37 * bump
    pts = np.round(v * r[:, None] + grid / 2.0)
    pts = np.unique(pts, axis=0)
    if pts.shape[0] > n_target:
        sel = rng.choice(pts.shape[0], n_target, replace=False)
        sel.sort()
        pts = pts[sel]
    normals = pts - grid / 2.0
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    colors = np.round(255 * (0.5 + 0.5 * np.sin(pts / 64.0))) / 255.0
    return pts, colors, normals


def degrade_gpcc_like(
    points: np.ndarray,
    colors: typing.Optional[np.ndarray],
    qp: int,
    seed: int = 0,
) -> typing.Tuple[np.ndarray, typing.Optional[np.ndarray]]:
    """G-PCC-flavoured degradation: geometry quantised by 2^(qp/6) with
    re-voxelisation (duplicate merge), colours perturbed ~qp/2 code levels.

    Not a codec — a reproducible stand-in with the same artefact structure
    (grid snapping, density loss, chroma noise) for rate-sweep pipelines.
    """
    rng = np.random.default_rng(seed + qp)
    step = max(1.0, 2.0 ** (qp / 6.0))
    q = np.round(points / step) * step
    q, idx = np.unique(q, axis=0, return_index=True)
    c = None
    if colors is not None:
        c = colors[idx]
        noise = rng.integers(-qp // 2 - 1, qp // 2 + 2, c.shape) / 255.0
        c = np.clip(np.round((c + noise) * 255.0) / 255.0, 0.0, 1.0)
    return q, c


def write_qp_sweep(
    out_dir: str,
    n_points: int = 100_000,
    qps: typing.Sequence[int] = (4, 10, 16, 22, 28, 34),
    seed: int = 0,
) -> typing.Tuple[str, typing.List[typing.Tuple[int, str]]]:
    """Materialise a reference PLY + one degraded PLY per QP.

    Returns (reference_path, [(qp, degraded_path), ...]).
    """
    from .io import write_ply

    os.makedirs(out_dir, exist_ok=True)
    pts, colors, normals = voxel_surface(n_points, seed=seed)
    ref_path = os.path.join(out_dir, "reference.ply")
    write_ply(ref_path, pts, colors=colors, normals=normals)
    out = []
    for qp in qps:
        q, c = degrade_gpcc_like(pts, colors, qp, seed=seed)
        p = os.path.join(out_dir, f"qp{qp:02d}.ply")
        write_ply(p, q, colors=c)
        out.append((qp, p))
    return ref_path, out
