"""Fused pair evaluation: every reduction the metric table needs, one pass.

Port of the pruned path of ``open_pcc_metric_tpu/ops/fused.py``: both NN
directions and the intra-origin self-NN run through the pruned search
(``nn_pruned.nn_pruned_sorted``), and every sum the table needs — squared
errors, running maxes (Hausdorff), per-channel colour errors on gathered
neighbours — is reduced on the clouds' device in Morton-sorted space. Only
scalars and 3-vectors leave the device; the host then applies the OBB peak
and log10s (``finalize_stats``).

Clouds without normals need the estimation slice (30-NN PCA normals),
which this package does not have yet.
"""
from __future__ import annotations

import concurrent.futures
import typing

import numpy as np
import torch

from .color import get_color_peak, transform_colors
from .grid import CHUNK
from .nn_pruned import nn_pruned_sorted
from ..utils.cache import ladder_lookup, ladder_store, next_rung


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Two-stage masked sum: 1024-row partial sums, then their sum (keeps
    float32 accumulation error ~sqrt(N) below a running sum)."""
    x = torch.where(mask if x.ndim == 1 else mask[:, None], x, 0)
    n = x.shape[0]
    chunk = 1024
    if n <= chunk:
        return x.sum(dim=0)
    pad = (-n) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x.reshape(-1, chunk, *x.shape[1:]).sum(dim=1).sum(dim=0)


def _masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask if x.ndim == 1 else mask[:, None], x,
                       -torch.inf).amax(dim=0)


def _masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, torch.inf).amin(dim=0)


def _check_backend(backend: str) -> None:
    if backend not in ("auto", "pruned"):
        raise NotImplementedError(
            f"backend {backend!r}: only the pruned backend is ported; the "
            "brute-force small-cloud backends come with a later slice")


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with indices clipped into range (JAX ``mode="clip"``)."""
    return x[idx.long().clamp(0, x.shape[0] - 1)]


def _pair_stats_pruned(
    a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm, ga, gb,
    a_col_sorted=None, b_col_sorted=None,
    *, color_scheme, point_to_plane, d2_mode, with_boundary,
    prune_cap, prune_fallback,
) -> typing.Dict[str, typing.Any]:
    """Device reductions for one pair, evaluated in Morton-sorted space.

    Sorted-row validity is ``row < n`` (sentinels sort last), neighbour
    indices come back in ORIGINAL order (so colour/normal/point gathers hit
    the original arrays), and only the reference-D2 positional pairing and
    the query-side colours need a perm gather.
    """
    dev = a_pts.device
    mask_a = torch.arange(a_pts.shape[0], device=dev) < n_a
    mask_b = torch.arange(b_pts.shape[0], device=dev) < n_b

    kw = dict(cap=prune_cap, fallback_tiles=prune_fallback)
    d0, i0, ov0 = nn_pruned_sorted(ga, gb, n_a, **kw)
    d1, i1, ov1 = nn_pruned_sorted(gb, ga, n_b, **kw)

    def gather_payload(pts, col, nrm, idx):
        # One concatenated row gather per direction (gathers pay per row).
        parts = [pts]
        if color_scheme is not None:
            parts.append(col)
        if point_to_plane and d2_mode != "reference":
            parts.append(nrm)
        pay = _gather_rows(torch.cat(parts, dim=1), idx)
        out = {"pts": pay[:, :3]}
        c = 3
        if color_scheme is not None:
            out["col"] = pay[:, c : c + 3]
            c += 3
        if point_to_plane and d2_mode != "reference":
            out["nrm"] = pay[:, c : c + 3]
        return out

    pay0 = gather_payload(b_pts, b_col, b_nrm, i0)
    pay1 = gather_payload(a_pts, a_col, a_nrm, i1)
    overflow = ov0 | ov1

    out: typing.Dict[str, typing.Any] = {
        "n_a": n_a,
        "n_b": n_b,
        "d1_sse_l": _masked_sum(d0, mask_a),
        "d1_sse_r": _masked_sum(d1, mask_b),
        "d1_max_l": _masked_max(d0, mask_a),
        "d1_max_r": _masked_max(d1, mask_b),
    }

    if with_boundary:
        dself, _, ov2 = nn_pruned_sorted(ga, ga, n_a, exclude_self=True, **kw)
        overflow = overflow | ov2
        sqrt_self = torch.sqrt(torch.clamp(dself, min=0.0))
        out["self_min"] = _masked_min(sqrt_self, mask_a)
        out["self_max"] = _masked_max(sqrt_self, mask_a)

    if point_to_plane:
        if a_nrm is None or b_nrm is None:
            raise ValueError("point_to_plane needs normals on both clouds")
        err0 = ga.points - pay0["pts"]
        err1 = gb.points - pay1["pts"]
        if d2_mode == "reference":
            # Positional pairing by ORIGINAL query index (SURVEY Q3).
            n_for_0 = _gather_rows(b_nrm, ga.perm)
            n_for_1 = _gather_rows(a_nrm, gb.perm)
        else:
            n_for_0 = pay0["nrm"]
            n_for_1 = pay1["nrm"]
        p0 = (err0 * n_for_0).sum(dim=1) ** 2
        p1 = (err1 * n_for_1).sum(dim=1) ** 2
        out["d2_sse_l"] = _masked_sum(p0, mask_a)
        out["d2_sse_r"] = _masked_sum(p1, mask_b)
        out["d2_max_l"] = _masked_max(p0, mask_a)
        out["d2_max_r"] = _masked_max(p1, mask_b)

    if color_scheme is not None:
        a_col_s = a_col_sorted if a_col_sorted is not None else a_col[ga.perm.long()]
        b_col_s = b_col_sorted if b_col_sorted is not None else b_col[gb.perm.long()]
        t0 = transform_colors(a_col_s, "rgb", color_scheme)
        tn0 = transform_colors(pay0["col"], "rgb", color_scheme)
        t1 = transform_colors(b_col_s, "rgb", color_scheme)
        tn1 = transform_colors(pay1["col"], "rgb", color_scheme)
        diff0 = t0 - tn0
        diff1 = t1 - tn1
        out["c_sse_l"] = _masked_sum(diff0**2, mask_a)
        out["c_sse_r"] = _masked_sum(diff1**2, mask_b)
        hd0, hd1 = diff0, diff1
        if color_scheme == "rgb":  # SURVEY Q5 quirk
            hd0 = 255.0 * hd0
            hd1 = 255.0 * hd1
        out["c_max_l"] = _masked_max(hd0**2, mask_a)
        out["c_max_r"] = _masked_max(hd1**2, mask_b)

    out["nn_overflow"] = overflow
    return out


def pair_stats(
    a_pts: torch.Tensor,
    b_pts: torch.Tensor,
    n_a: int,
    n_b: int,
    a_col: typing.Optional[torch.Tensor] = None,
    b_col: typing.Optional[torch.Tensor] = None,
    a_nrm: typing.Optional[torch.Tensor] = None,
    b_nrm: typing.Optional[torch.Tensor] = None,
    ga=None,
    gb=None,
    a_col_sorted: typing.Optional[torch.Tensor] = None,
    b_col_sorted: typing.Optional[torch.Tensor] = None,
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    d2_mode: str = "reference",
    with_boundary: bool = True,
    backend: str = "pruned",
    prune_cap: int = 32,
    prune_fallback: int = 256,
) -> typing.Dict[str, typing.Any]:
    """Device-side reductions for the full metric suite (tensors on the
    clouds' device; ``nn_overflow`` reports certificate overflow — the
    caller must re-run with a larger prune_cap/prune_fallback)."""
    _check_backend(backend)
    from .grid import build_grid

    if ga is None:
        ga = build_grid(a_pts, n_a)
    if gb is None:
        gb = build_grid(b_pts, n_b)
    return _pair_stats_pruned(
        a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm, ga, gb,
        a_col_sorted, b_col_sorted,
        color_scheme=color_scheme, point_to_plane=point_to_plane,
        d2_mode=d2_mode, with_boundary=with_boundary,
        prune_cap=prune_cap, prune_fallback=prune_fallback,
    )


def _to_host(stats: typing.Dict[str, typing.Any]) -> typing.Dict[str, np.ndarray]:
    """All device values to float64 numpy in ONE device-to-host copy."""
    keys = [k for k, v in stats.items() if isinstance(v, torch.Tensor)]
    out = {k: np.asarray(v, dtype=np.float64) for k, v in stats.items()
           if k not in keys}
    if keys:
        flat = torch.cat([stats[k].reshape(-1).to(torch.float64) for k in keys])
        flat = flat.cpu().numpy()
        o = 0
        for k in keys:
            shape = tuple(stats[k].shape)
            size = int(np.prod(shape))
            out[k] = flat[o : o + size].reshape(shape)
            o += size
    return out


def finalize_stats(
    stats: typing.Dict[str, typing.Any],
    extent_peak: float,
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    peak: typing.Optional[float] = None,
) -> typing.Dict[str, np.float64]:
    """Host epilogue: MSEs, PSNRs and symmetric selections from raw sums.

    Reproduces the reference's peak conventions (SURVEY Q4): geometric PSNR
    peak = max OBB extent; Hausdorff PSNR peak = max intra-origin NN distance.
    A user-supplied ``peak`` (pc_error's --resolution convention) overrides
    BOTH geometric peaks.
    """
    s = _to_host(stats)
    n_a, n_b = float(s["n_a"]), float(s["n_b"])
    gpeak = float(peak) if peak is not None else extent_peak
    out: typing.Dict[str, typing.Any] = {}
    with np.errstate(divide="ignore"):
        out["min_sqrt"] = np.float64(s["self_min"])
        out["max_sqrt"] = np.float64(s["self_max"])
        mse_l, mse_r = s["d1_sse_l"] / n_a, s["d1_sse_r"] / n_b
        out["geo_mse_left"], out["geo_mse_right"] = mse_l, mse_r
        out["geo_mse_sym"] = max(mse_l, mse_r)
        psnr_l = 10 * np.log10(gpeak**2 / mse_l)
        psnr_r = 10 * np.log10(gpeak**2 / mse_r)
        out["geo_psnr_left"], out["geo_psnr_right"] = psnr_l, psnr_r
        out["geo_psnr_sym"] = min(psnr_l, psnr_r)
        out["geo_hausdorff_left"] = s["d1_max_l"]
        out["geo_hausdorff_right"] = s["d1_max_r"]
        out["geo_hausdorff_sym"] = max(s["d1_max_l"], s["d1_max_r"])
        hpeak2 = gpeak**2 if peak is not None else out["max_sqrt"] ** 2
        out["geo_hausdorff_psnr_left"] = 10 * np.log10(hpeak2 / s["d1_max_l"])
        out["geo_hausdorff_psnr_right"] = 10 * np.log10(hpeak2 / s["d1_max_r"])
        out["geo_hausdorff_psnr_sym"] = min(
            out["geo_hausdorff_psnr_left"], out["geo_hausdorff_psnr_right"]
        )
        if point_to_plane:
            d2_l, d2_r = s["d2_sse_l"] / n_a, s["d2_sse_r"] / n_b
            out["d2_mse_left"], out["d2_mse_right"] = d2_l, d2_r
            out["d2_mse_sym"] = max(d2_l, d2_r)
            dp_l = 10 * np.log10(gpeak**2 / d2_l)
            dp_r = 10 * np.log10(gpeak**2 / d2_r)
            out["d2_psnr_left"], out["d2_psnr_right"] = dp_l, dp_r
            out["d2_psnr_sym"] = min(dp_l, dp_r)
            out["d2_hausdorff_left"] = s["d2_max_l"]
            out["d2_hausdorff_right"] = s["d2_max_r"]
            out["d2_hausdorff_sym"] = max(s["d2_max_l"], s["d2_max_r"])
            out["d2_hausdorff_psnr_left"] = 10 * np.log10(hpeak2 / s["d2_max_l"])
            out["d2_hausdorff_psnr_right"] = 10 * np.log10(hpeak2 / s["d2_max_r"])
            out["d2_hausdorff_psnr_sym"] = min(
                out["d2_hausdorff_psnr_left"], out["d2_hausdorff_psnr_right"]
            )
        if color_scheme is not None:
            cm_l, cm_r = s["c_sse_l"] / n_a, s["c_sse_r"] / n_b
            out["color_mse_left"], out["color_mse_right"] = cm_l, cm_r
            out["color_mse_sym"] = max([cm_l, cm_r], key=np.linalg.norm)
            cpeak = get_color_peak(color_scheme)
            cp_l = 10 * np.log10(cpeak**2 / cm_l)
            cp_r = 10 * np.log10(cpeak**2 / cm_r)
            out["color_psnr_left"], out["color_psnr_right"] = cp_l, cp_r
            out["color_psnr_sym"] = min([cp_l, cp_r], key=np.linalg.norm)
            out["color_hausdorff_left"] = s["c_max_l"]
            out["color_hausdorff_right"] = s["c_max_r"]
            out["color_hausdorff_sym"] = max(
                [s["c_max_l"], s["c_max_r"]], key=np.linalg.norm
            )
            chp_l = 10 * np.log10(cpeak**2 / s["c_max_l"])
            chp_r = 10 * np.log10(cpeak**2 / s["c_max_r"])
            out["color_hausdorff_psnr_left"] = chp_l
            out["color_hausdorff_psnr_right"] = chp_r
            out["color_hausdorff_psnr_sym"] = min(
                [chp_l, chp_r], key=np.linalg.norm
            )
    return out


def _sorted_colors(cloud) -> typing.Optional[torch.Tensor]:
    """Per-Cloud cached Morton-sorted colours (one gather per cloud ever)."""
    if cloud.colors is None:
        return None
    if cloud._sorted_colors is None:
        cloud._sorted_colors = cloud.colors[cloud.get_grid().perm.long()]
    return cloud._sorted_colors


def _ladder(n_chunks: int, run, cap: int, fallback: int):
    """Escalate (cap, fallback) until ``run`` certifies; returns its result."""
    while True:
        result, overflow = run(cap, fallback)
        # Exact iff certified, or stage 1 refined every chunk (at which
        # point the certificate cannot fail).
        if not overflow or cap >= n_chunks:
            return result, (cap, fallback)
        cap, fallback = next_rung(cap, fallback, n_chunks, n_chunks)


def boundary_stats(cloud, backend: str = "auto", prune_cap: int = 32,
                   prune_fallback: int = 256):
    """Cached (min, max) intra-cloud NN distances of one cloud (device
    0-d tensors). They depend only on the cloud (reference:
    cloud_pair.py:108-109), so a sweep sharing one reference cloud computes
    the priciest NN pass once."""
    if cloud._boundary_stats is not None:
        return cloud._boundary_stats
    if int(cloud.n) < 2:
        raise ValueError(
            "intra-cloud NN distances need at least 2 points; the cloud "
            f"has {int(cloud.n)}"
        )
    _check_backend(backend)
    g = cloud.get_grid()

    def run(cap, fallback):
        d, _, overflow = nn_pruned_sorted(
            g, g, cloud.n, exclude_self=True, cap=cap, fallback_tiles=fallback)
        return d, bool(overflow)

    d, _ = _ladder(cloud.padded_size // CHUNK, run, prune_cap, prune_fallback)
    mask = cloud.valid_mask()
    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    cloud._boundary_stats = (_masked_min(sqrt_d, mask), _masked_max(sqrt_d, mask))
    return cloud._boundary_stats


def _prefetch_obb(a, peak):
    """Start the OBB peak on a thread, overlapped with the NN passes.
    Skipped when a user peak makes it irrelevant or the extent is cached;
    returns a future or None."""
    if peak is not None or a._obb_extent is not None:
        return None
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(a.get_obb_extent)
    pool.shutdown(wait=False)
    return fut


# Remembers the certificate-passing (cap, fallback) rung per problem shape
# so a sweep of same-shaped pairs starts at the rung that worked instead of
# re-climbing the cheaper-but-overflowing rungs per pair. Not monotone:
# ladder_lookup retries the base rung periodically.
_LADDER_MEMO: dict = {}


def fused_evaluate(
    a, b, color_scheme=None, point_to_plane=False, d2_mode="reference",
    backend: str = "auto", peak: typing.Optional[float] = None,
    prune_cap: int = 32, prune_fallback: int = 256,
) -> typing.Dict[str, np.float64]:
    """Full fused evaluation of a Cloud pair on the clouds' device.

    ``prune_cap``/``prune_fallback`` are the base rung of the certificate
    ladder; an overflowing rung escalates through ``next_rung`` (one
    synchronous overflow readback per attempt).
    """
    _check_backend(backend)
    backend = "pruned"
    if a.device != b.device or a.points.dtype != b.points.dtype:
        raise ValueError("both clouds must share one device and dtype")
    if point_to_plane and d2_mode == "reference" and a.n > b.n:
        raise IndexError(
            "reference D2 mode requires n_origin <= n_reconst "
            f"(got {a.n} > {b.n}); use d2_mode='pc_error'"
        )
    if point_to_plane and (a.normals is None or b.normals is None):
        raise NotImplementedError(
            "point-to-plane metrics on a cloud without normals need normal "
            "estimation, which comes with the estimation slice (30-NN PCA "
            "normals); supply normals in the files for now")
    if int(a.n) < 2 and a._boundary_stats is None:
        raise ValueError(
            "intra-cloud NN distances need at least 2 points; the cloud "
            f"has {int(a.n)}"
        )
    obb_future = _prefetch_obb(a, peak)
    ga, gb = a.get_grid(), b.get_grid()
    a_col_sorted = b_col_sorted = None
    if color_scheme is not None:
        a_col_sorted = _sorted_colors(a)
        b_col_sorted = _sorted_colors(b)
    # The self-NN pass is folded in when the origin's boundary stats are
    # not cached yet; the result is cached either way.
    with_boundary = a._boundary_stats is None
    memo_key = (a.padded_size, b.padded_size, str(a.points.dtype),
                color_scheme, point_to_plane, d2_mode, backend)
    max_chunks = max(a.padded_size, b.padded_size) // CHUNK

    def run(cap, fallback):
        stats = pair_stats(
            a.points, b.points, a.n, b.n, a.colors, b.colors,
            a.normals, b.normals, ga, gb, a_col_sorted, b_col_sorted,
            color_scheme=color_scheme, point_to_plane=point_to_plane,
            d2_mode=d2_mode, with_boundary=with_boundary, backend=backend,
            prune_cap=cap, prune_fallback=fallback,
        )
        if not with_boundary:
            stats["self_min"], stats["self_max"] = a._boundary_stats
        host = _to_host(stats)  # one round-trip: results + overflow
        return (stats, host), bool(host["nn_overflow"])

    cap, fallback = ladder_lookup(_LADDER_MEMO, memo_key,
                                  (prune_cap, prune_fallback))
    (stats, host), rung = _ladder(max_chunks, run, cap, fallback)
    ladder_store(_LADDER_MEMO, memo_key, rung)
    if with_boundary:
        a._boundary_stats = (stats["self_min"], stats["self_max"])
    # User peak (pc_error --resolution) skips the OBB entirely.
    if peak is not None:
        extent_peak = float(peak)
    elif obb_future is not None:
        extent_peak = float(np.max(obb_future.result()))
    else:
        extent_peak = float(np.max(a.get_obb_extent()))
    return finalize_stats(
        host, extent_peak, color_scheme=color_scheme,
        point_to_plane=point_to_plane, peak=peak
    )
