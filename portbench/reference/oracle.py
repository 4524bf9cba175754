"""The plain reference: every entry of open-pcc-metric's table, in NumPy.

A frozen copy of the metric arithmetic the repository's tests hold both
packages to (open-pcc-metric's formulas with its peak conventions and
pc_error's D2 and ``--resolution`` options), on exact nearest neighbours
from SciPy's k-d tree with the lowest original index among equal
distances, 30-NN PCA normals from LAPACK, and the minimal-OBB peak of
``obb.py``. It imports nothing of the program and is handed only the
generated clouds.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
correctness control: the same arithmetic with every product's operands
rounded to TF32 (10 mantissa bits) and everything held and summed in
float32, the step below the program's float32-without-TF32. Its searches
rank the k-d tree's candidates by distances taken in that arithmetic.
"""
from __future__ import annotations

import typing

import numpy as np

from . import obb

RGB_TO_YCC = np.array([[0.2126, 0.7152, 0.0722],
                       [-0.1146, -0.3854, 0.5],
                       [0.5, -0.4542, -0.0458]])
RGB_TO_YUV = np.array([[0.25, 0.5, 0.25], [1.0, 0.0, -1.0],
                       [-0.5, 1.0, -0.5]])
K_NORMALS = 30


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to TF32 (float32 with 10 mantissa bits), to nearest,
    ties to even, held as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


class Arith(typing.NamedTuple):
    dtype: typing.Any
    mul: typing.Callable  # rounds a product's operand

    def sqdist(self, q: np.ndarray, c: np.ndarray) -> np.ndarray:
        """Squared distances of rows ``q`` (..., 3) to ``c`` (..., 3)."""
        d = self.mul(np.asarray(q, self.dtype) - np.asarray(c, self.dtype))
        return (d * d).astype(self.dtype).sum(axis=-1, dtype=self.dtype)

    @staticmethod
    def of(precision: str) -> "Arith":
        if precision == "float64":
            return Arith(np.float64, lambda x: np.asarray(x, np.float64))
        if precision == "tf32":
            return Arith(np.float32, tf32)
        raise ValueError(f"unknown precision {precision!r}")


# --------------------------------------------------------------- searches

F64 = Arith.of("float64")


def nn(a: np.ndarray, b: np.ndarray, exclude_self: bool = False,
       workers: int = -1, ar: Arith = F64
       ) -> typing.Tuple[np.ndarray, np.ndarray]:
    """Exact 1-NN of each row of ``a`` among the rows of ``b``: (index,
    squared distance as ``ar`` takes it), the lowest index among equal
    distances.
    A row is settled once the farthest of its k candidates is strictly
    farther than the nearest, so no unreturned point can tie it; the
    others are asked again with 4 times the k. The first k, 12, holds
    the 8 corners of a voxel that a point on a coarser lattice can be
    equally near."""
    from scipy.spatial import cKDTree

    tree = cKDTree(b)
    n = a.shape[0]
    idx = np.empty(n, dtype=np.int64)
    dist = np.empty(n, dtype=np.float64)
    rows = np.arange(n)
    k = 12
    while rows.size:
        kq = min(k, b.shape[0])
        _, cand = tree.query(a[rows], k=kq, workers=workers)
        cand = cand.reshape(rows.size, kq)
        dsq = ar.sqdist(a[rows, None, :], b[cand]).astype(np.float64)
        if exclude_self:
            dsq[cand == rows[:, None]] = np.inf
        dmin = dsq.min(axis=1)
        low = np.where(dsq == dmin[:, None], cand,
                       np.iinfo(np.int64).max).min(axis=1)
        kth = np.where(np.isfinite(dsq), dsq, -np.inf).max(axis=1)
        done = (kth > dmin) | (kq >= b.shape[0])
        idx[rows[done]] = low[done]
        dist[rows[done]] = dmin[done]
        rows = rows[~done]
        k *= 4
    return idx, dist


def knn(a: np.ndarray, b: np.ndarray, k: int, workers: int = -1,
        block: int = 1 << 17, ar: Arith = F64) -> np.ndarray:
    """Exact k-NN sets of each row of ``a`` among the rows of ``b`` (itself
    included when ``a`` is ``b``): (n, k) indices, unordered within a row.
    The set is every point nearer than the k-th distance and, of those at
    exactly the k-th distance, the lowest indices. A row is settled once
    its farthest returned candidate is strictly farther than its k-th; the
    others are asked again with 4 times the candidates. Rows go in blocks
    to bound the memory."""
    from scipy.spatial import cKDTree

    tree = cKDTree(b)
    out = np.empty((a.shape[0], k), dtype=np.int64)
    big = np.iinfo(np.int64).max
    for s in range(0, a.shape[0], block):
        rows = np.arange(s, min(s + block, a.shape[0]))
        kq = k + 8
        while rows.size:
            kq = min(kq, b.shape[0])
            _, cand = tree.query(a[rows], k=kq, workers=workers)
            cand = cand.reshape(rows.size, kq)
            dsq = ar.sqdist(a[rows, None, :], b[cand]).astype(np.float64)
            dk = np.partition(dsq, k - 1, axis=1)[:, k - 1:k]
            done = (dsq.max(axis=1) > dk[:, 0]) | (kq >= b.shape[0])
            inside = dsq < dk
            need = k - inside.sum(axis=1, keepdims=True)  # >= 1
            tied = np.where(dsq == dk, cand, big)
            cut = np.take_along_axis(np.sort(tied, axis=1), need - 1, axis=1)
            pick = inside | (tied <= cut)
            got = cand[done][pick[done]].reshape(-1, k)
            out[rows[done]] = got
            rows = rows[~done]
            kq *= 4
    return out


def pca_normals(points: np.ndarray, ar: Arith, workers: int = -1,
                block: int = 1 << 17) -> np.ndarray:
    """Open3D's normals: the eigenvector of the smallest eigenvalue of the
    covariance of each point's 30 nearest neighbours, itself included
    (unoriented)."""
    idx = knn(points, points, K_NORMALS, workers=workers, ar=ar)
    out = np.empty(points.shape, dtype=ar.dtype)
    for s in range(0, points.shape[0], block):
        nb = points[idx[s:s + block]].astype(ar.dtype)  # (n, k, 3)
        c = nb - nb.mean(axis=1, keepdims=True, dtype=ar.dtype)
        cm = ar.mul(c)
        cov = (cm.transpose(0, 2, 1) @ cm).astype(ar.dtype) / ar.dtype(
            K_NORMALS)
        out[s:s + block] = np.linalg.eigh(cov)[1][:, :, 0]
    return out


# ---------------------------------------------------------------- metrics

class Searches(typing.NamedTuple):
    """Exact searches one pair needs: both directions' neighbours and
    squared distances, the origin's intra-cloud distances."""

    idx_ab: np.ndarray
    d_ab: np.ndarray
    idx_ba: np.ndarray
    d_ba: np.ndarray
    d_self: np.ndarray


def searches(a: np.ndarray, b: np.ndarray,
             d_self: typing.Optional[np.ndarray] = None,
             workers: int = -1, precision: str = "float64") -> Searches:
    """``d_self``, the origin's own 1-NN distances, may come from an
    earlier pair with the same origin."""
    ar = Arith.of(precision)
    ia, da = nn(a, b, workers=workers, ar=ar)
    ib, db = nn(b, a, workers=workers, ar=ar)
    if d_self is None:
        _, d_self = nn(a, a, exclude_self=True, workers=workers, ar=ar)
    return Searches(ia, da, ib, db, d_self)


def _mean(x: np.ndarray, ar: Arith, axis=0):
    return x.astype(ar.dtype).sum(axis=axis, dtype=ar.dtype) / ar.dtype(
        x.shape[0])


def _log_psnr(peak2, mse, ar: Arith):
    with np.errstate(divide="ignore"):
        return ar.dtype(10) * np.log10(ar.dtype(peak2) / mse)


def _transform(colors: np.ndarray, scheme: str, ar: Arith) -> np.ndarray:
    if scheme == "rgb":
        return colors.astype(ar.dtype)
    m = RGB_TO_YCC if scheme == "ycc" else RGB_TO_YUV
    return (ar.mul(colors) @ ar.mul(m).T).astype(ar.dtype)


def table(a_pts, b_pts, a_col, b_col, a_nrm, b_nrm, opts: dict,
          s: Searches, precision: str = "float64",
          extent: typing.Optional[np.ndarray] = None,
          workers: int = -1) -> typing.Dict[str, typing.Any]:
    """Every entry of the pair's table, keyed as the port's fused
    evaluation names them. ``opts``: ``color`` (scheme or None),
    ``hausdorff``, ``point_to_plane``, ``d2_mode`` ("reference" or
    "pc_error"), ``peak`` (None for the OBB peak). A cloud without normals
    (``None``) gets PCA normals under point-to-plane. ``extent`` may carry
    the origin's OBB extent from an earlier pair in this precision."""
    ar = Arith.of(precision)
    dt = ar.dtype
    out: typing.Dict[str, typing.Any] = {}
    boundary = np.sqrt(s.d_self.astype(dt))
    out["min_sqrt"] = boundary.min()
    out["max_sqrt"] = boundary.max()
    user_peak = opts.get("peak")
    if user_peak is not None:
        peak = dt(user_peak)
    else:
        if extent is None:
            extent = obb.minimal_obb_extent(a_pts, ar.mul, dt)
        peak = dt(extent.max())
    peak2 = peak * peak
    hpeak2 = peak2 if user_peak is not None else out["max_sqrt"] ** 2

    da, db = s.d_ab.astype(dt), s.d_ba.astype(dt)
    mse_l, mse_r = _mean(da, ar), _mean(db, ar)
    out["geo_mse_left"], out["geo_mse_right"] = mse_l, mse_r
    out["geo_mse_sym"] = max(mse_l, mse_r)
    pl, pr = _log_psnr(peak2, mse_l, ar), _log_psnr(peak2, mse_r, ar)
    out["geo_psnr_left"], out["geo_psnr_right"] = pl, pr
    out["geo_psnr_sym"] = min(pl, pr)
    if opts.get("hausdorff"):
        hl, hr = da.max(), db.max()
        out["geo_hausdorff_left"], out["geo_hausdorff_right"] = hl, hr
        out["geo_hausdorff_sym"] = max(hl, hr)
        hpl, hpr = _log_psnr(hpeak2, hl, ar), _log_psnr(hpeak2, hr, ar)
        out["geo_hausdorff_psnr_left"] = hpl
        out["geo_hausdorff_psnr_right"] = hpr
        out["geo_hausdorff_psnr_sym"] = min(hpl, hpr)

    if opts.get("point_to_plane"):
        if a_nrm is None:
            a_nrm = pca_normals(a_pts, ar, workers)
        if b_nrm is None:
            b_nrm = pca_normals(b_pts, ar, workers)
        err_l = a_pts.astype(dt) - b_pts[s.idx_ab].astype(dt)
        err_r = b_pts.astype(dt) - a_pts[s.idx_ba].astype(dt)
        if opts.get("d2_mode", "reference") == "reference":
            # open-pcc-metric projects onto the other cloud's normal at the
            # query's own position, not at its neighbour's.
            n_l, n_r = b_nrm[:err_l.shape[0]], a_nrm[:err_r.shape[0]]
        else:
            n_l, n_r = b_nrm[s.idx_ab], a_nrm[s.idx_ba]
        p_l = ((ar.mul(err_l) * ar.mul(n_l)).astype(dt).sum(
            axis=1, dtype=dt)) ** 2
        p_r = ((ar.mul(err_r) * ar.mul(n_r)).astype(dt).sum(
            axis=1, dtype=dt)) ** 2
        ml, mr = _mean(p_l, ar), _mean(p_r, ar)
        out["d2_mse_left"], out["d2_mse_right"] = ml, mr
        out["d2_mse_sym"] = max(ml, mr)
        dpl, dpr = _log_psnr(peak2, ml, ar), _log_psnr(peak2, mr, ar)
        out["d2_psnr_left"], out["d2_psnr_right"] = dpl, dpr
        out["d2_psnr_sym"] = min(dpl, dpr)
        if opts.get("hausdorff"):
            hl, hr = p_l.max(), p_r.max()
            out["d2_hausdorff_left"], out["d2_hausdorff_right"] = hl, hr
            out["d2_hausdorff_sym"] = max(hl, hr)
            hpl, hpr = _log_psnr(hpeak2, hl, ar), _log_psnr(hpeak2, hr, ar)
            out["d2_hausdorff_psnr_left"] = hpl
            out["d2_hausdorff_psnr_right"] = hpr
            out["d2_hausdorff_psnr_sym"] = min(hpl, hpr)

    scheme = opts.get("color")
    if scheme is not None:
        ta = _transform(a_col, scheme, ar)
        tb = _transform(b_col, scheme, ar)
        diff_l = ta - tb[s.idx_ab]
        diff_r = tb - ta[s.idx_ba]
        cl, cr = _mean(diff_l ** 2, ar), _mean(diff_r ** 2, ar)
        out["color_mse_left"], out["color_mse_right"] = cl, cr
        out["color_mse_sym"] = max([cl, cr], key=np.linalg.norm)
        cpeak2 = dt(255.0 ** 2) if scheme == "rgb" else dt(1.0)
        cpl, cpr = _log_psnr(cpeak2, cl, ar), _log_psnr(cpeak2, cr, ar)
        out["color_psnr_left"], out["color_psnr_right"] = cpl, cpr
        out["color_psnr_sym"] = min([cpl, cpr], key=np.linalg.norm)
    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}
