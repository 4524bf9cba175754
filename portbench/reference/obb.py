"""Approximate minimal-volume oriented bounding box, in NumPy and SciPy.

The geometric PSNR peak of open-pcc-metric's default convention is the
largest side of the origin cloud's minimal oriented bounding box, as
Open3D's ``CreateFromPointsMinimal`` finds it: over the convex hull's
triangles, the frame whose first axis runs along one edge and whose third
is the face normal; the frame whose box around the hull's vertices has the
least volume wins, and its box's sides are the extent.

``mul`` rounds the operands of every product the sweep takes (identity
for float64; TF32 rounding for the control); ``dtype`` is the type the
products and extents are held in.
"""
from __future__ import annotations

import typing

import numpy as np


def minimal_obb_extent(points: np.ndarray,
                       mul: typing.Callable = lambda x: x,
                       dtype=np.float64) -> np.ndarray:
    from scipy.spatial import ConvexHull

    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if points.shape[0] < 4:
        return (points.max(axis=0) - points.min(axis=0)).astype(dtype)
    try:
        hull = ConvexHull(points)
    except Exception:  # coplanar or collinear: qhull's joggled hull
        hull = ConvexHull(points, qhull_options="QJ")
    verts = points[hull.vertices].astype(dtype)
    tri = points[hull.simplices]  # (T, 3, 3)
    edge = tri[:, 1] - tri[:, 0]
    other = tri[:, 2] - tri[:, 0]
    normal = np.cross(edge, other)
    side = np.cross(normal, edge)
    axes = []
    ok = np.ones(tri.shape[0], dtype=bool)
    for vec in (edge, side, normal):
        length = np.linalg.norm(vec, axis=1)
        good = length > 1e-300
        ok &= good
        axes.append(vec / np.where(good, length, 1.0)[:, None])
    frames = np.stack(axes, axis=1).astype(dtype)  # (T, 3 axes, 3)
    vt = mul(verts).T
    ext = np.empty((frames.shape[0], 3), dtype=dtype)
    step = max(1, (1 << 22) // max(1, verts.shape[0]))
    for s in range(0, frames.shape[0], step):
        proj = mul(frames[s:s + step]) @ vt  # (t, 3, V)
        ext[s:s + step] = proj.max(axis=2) - proj.min(axis=2)
    vol = np.where(ok, ext.prod(axis=1), np.inf)
    best = int(np.argmin(vol))
    if not np.isfinite(vol[best]):
        return (points.max(axis=0) - points.min(axis=0)).astype(dtype)
    return ext[best]
