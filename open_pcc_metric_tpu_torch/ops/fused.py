"""Fused pair evaluation: every reduction the metric table needs, one pass.

Port of ``open_pcc_metric_tpu/ops/fused.py``: both NN
directions and the intra-origin self-NN, then every sum the table needs —
squared errors, running maxes (Hausdorff), per-channel colour errors on
gathered neighbours — reduced on the clouds' device. Clouds at or above
``nn.PRUNE_THRESHOLD`` padded rows go through the pruned search
(``nn_pruned.nn_pruned_sorted``, K1) in Morton-sorted space with the
certificate ladder; smaller ones through the brute force (``nn.nn_argmin``,
K5) in original order. Only scalars and 3-vectors leave the device; the
host then applies the OBB peak and log10s (``finalize_stats``).

Under point-to-plane a cloud without normals gets them estimated
(30-NN PCA through the pruned k-NN with in-kernel moments,
``ops/normals.py``); the estimation caches the origin's boundary stats on
the way, so the self-NN sweep is then skipped.

``fused_evaluate`` takes one of two routes, where the JAX package takes
them. The cold-pair fold (``cold_pair_program``) serves a pruned pair of
clouds at or above the estimation's pruning threshold when, under
point-to-plane, a cloud still needs its normals estimated, or when a
cloud's grid or sorted colours are not built yet (``_cold_fold_applicable``):
the first evaluation of every pair read from files, and every new
degraded frame of a sweep. It builds the missing grids, estimates the
missing normals at one rung for both clouds, runs the sweeps and reads
back once; on any certificate overflow the call reruns stepwise. Every
other pair runs stepwise: ``Cloud.get_normals`` and ``Cloud.get_grid``
with their own ladders, then ``pair_stats`` and one readback an attempt.

Knobs pick the pruned sweeps' schedules (``nn_pruned`` module docstring)
with the same tables either way; under ``PCC_PAYLOAD_KERNEL=1`` the two
cross sweeps of a float32 pair that needs colours or normals return the
neighbours' points, colours and normals from K6 instead of a gather. Each
public entry (``fused_evaluate``, ``pair_stats``, ``boundary_stats``,
``cold_pair_program``) resolves them and the ladder's base rung
(``PCC_NN_CAP``, ``PCC_NN_FT``) once, at its call, into one ``NnSchedule``
(``resolve_nn_schedule``); the layers below take that value, and every
ladder is ``utils.cache.climb``.
"""
from __future__ import annotations

import concurrent.futures
import typing

import numpy as np
import torch

from . import nn as nn_ops
from .color import get_color_peak, transform_colors
from .grid import CHUNK
from . import obb
# nn_base_rung and resolve_payload stay importable from this module.
from .nn_pruned import (  # noqa: F401
    NnSchedule, nn_base_rung, nn_pruned_sorted, nn_pruned_sorted_payload,
    resolve_nn_schedule, resolve_payload)
from .refine import PAYLOAD_F
from .._layout_args import check_pack
from ..utils.cache import climb, ladder_lookup, ladder_store
from ..utils.profiling import span, spanned


def _masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return stable_sum(torch.where(mask if x.ndim == 1 else mask[:, None], x, 0))


def stable_sum(x: torch.Tensor) -> torch.Tensor:
    """Two-stage sum over rows: 1024-row partial sums, then their sum (keeps
    float32 accumulation error ~sqrt(N) below a running sum)."""
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


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with indices clipped into range (JAX ``mode="clip"``)."""
    return x[idx.long().clamp(0, x.shape[0] - 1)]


def _gather_payload(pts, col, nrm, idx, *, color_scheme, point_to_plane,
                    d2_mode) -> typing.Dict[str, torch.Tensor]:
    """The neighbours' points, colours and (pc_error D2) normals: one
    concatenated row gather per direction (gathers pay per row)."""
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


def _pack_payload(pts, col, nrm) -> torch.Tensor:
    """(P, PAYLOAD_F) K6 payload rows [pts, col or 0, nrm or 0, 0 x 7]."""
    zero = pts.new_zeros((pts.shape[0], 3))
    return torch.cat([pts, col if col is not None else zero,
                      nrm if nrm is not None else zero,
                      pts.new_zeros((pts.shape[0], PAYLOAD_F - 9))], dim=1)


def _split_payload(pay) -> typing.Dict[str, torch.Tensor]:
    return {"pts": pay[:, :3], "col": pay[:, 3:6], "nrm": pay[:, 6:9]}


def _reduce_pair(out, masks, dists, queries, pays, d2_normals, query_cols,
                 *, color_scheme, point_to_plane) -> None:
    """Fill ``out`` with both directions' masked sums and maxima. Every
    argument after ``out`` is a (left, right) pair: the valid-row masks,
    the squared NN distances, the query points, the neighbour payloads
    (``_gather_payload``), the normals each D2 error is projected on and
    the query-side colours, all in one row order per direction."""
    for side, mask, d in zip("lr", masks, dists):
        out[f"d1_sse_{side}"] = _masked_sum(d, mask)
        out[f"d1_max_{side}"] = _masked_max(d, mask)
    if point_to_plane:
        for side, mask, q, pay, nrm in zip("lr", masks, queries, pays,
                                           d2_normals):
            p = ((q - pay["pts"]) * nrm).sum(dim=1) ** 2
            out[f"d2_sse_{side}"] = _masked_sum(p, mask)
            out[f"d2_max_{side}"] = _masked_max(p, mask)
    if color_scheme is not None:
        for side, mask, col, pay in zip("lr", masks, query_cols, pays):
            diff = (transform_colors(col, "rgb", color_scheme)
                    - transform_colors(pay["col"], "rgb", color_scheme))
            out[f"c_sse_{side}"] = _masked_sum(diff**2, mask)
            if color_scheme == "rgb":  # SURVEY Q5 quirk
                diff = 255.0 * diff
            out[f"c_max_{side}"] = _masked_max(diff**2, mask)


def _check_normals(a_nrm, b_nrm, point_to_plane) -> None:
    if point_to_plane and (a_nrm is None or b_nrm is None):
        raise ValueError("point_to_plane needs normals on both clouds")


def _sorted_rows(x, perm, cached):
    """``cached`` when given, else the rows of ``x`` in sorted order (None
    for no ``x``)."""
    if cached is not None or x is None:
        return cached
    return x[perm.long()]


def _sweep_kw(nn: NnSchedule, mxu_ok: bool) -> typing.Dict[str, typing.Any]:
    """``nn_pruned_sorted``'s keywords for the resolved schedule ``nn``:
    every knob given, so the search reads none from the environment."""
    return dict(cap=nn.cap, fallback_tiles=nn.fallback, p1=nn.p1,
                prologue=nn.prologue, refine_impl=nn.refine_impl,
                mxu_ok=mxu_ok, sched=nn.sched)


def _pair_stats_pruned(
    a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm, ga, gb,
    a_col_sorted=None, b_col_sorted=None, a_nrm_sorted=None,
    b_nrm_sorted=None,
    *, color_scheme, point_to_plane, d2_mode, with_boundary, nn: NnSchedule,
    mxu_ok,
) -> typing.Dict[str, typing.Any]:
    """Device reductions for one pair, evaluated in Morton-sorted space.

    Sorted-row validity is ``row < n`` (sentinels sort last), neighbour
    indices come back in ORIGINAL order (so colour/normal/point gathers hit
    the original arrays), and only the reference-D2 positional pairing and
    the query-side colours need a perm gather. Every sweep runs the
    schedule ``nn`` at its rung (``refine_impl`` gated by ``mxu_ok``),
    except that with ``nn.payload`` the cross sweeps of a float32 pair that
    needs colours or normals run ``nn_pruned_sorted_payload`` (K6), as in
    the JAX package.
    """
    _check_normals(a_nrm, b_nrm, point_to_plane)
    dev = a_pts.device
    masks = (torch.arange(a_pts.shape[0], device=dev) < n_a,
             torch.arange(b_pts.shape[0], device=dev) < n_b)
    kw = _sweep_kw(nn, mxu_ok)
    if (nn.payload and (color_scheme is not None or point_to_plane)
            and a_pts.dtype == torch.float32):

        def packs(g, pts, col, nrm, col_s, nrm_s):
            """A search cloud's payload rows, sorted and original order."""
            col = col if color_scheme is not None else None
            nrm = nrm if point_to_plane else None
            col_s = None if col is None else _sorted_rows(col, g.perm, col_s)
            nrm_s = None if nrm is None else _sorted_rows(nrm, g.perm, nrm_s)
            return _pack_payload(g.points, col_s, nrm_s), _pack_payload(
                pts, col, nrm)

        pkw = dict(cap=nn.cap, fallback_tiles=nn.fallback)
        d0, i0, p0, ov0 = nn_pruned_sorted_payload(
            ga, gb, *packs(gb, b_pts, b_col, b_nrm, b_col_sorted,
                           b_nrm_sorted), n_a, **pkw)
        d1, i1, p1, ov1 = nn_pruned_sorted_payload(
            gb, ga, *packs(ga, a_pts, a_col, a_nrm, a_col_sorted,
                           a_nrm_sorted), n_b, **pkw)
        pays = (_split_payload(p0), _split_payload(p1))
    else:
        d0, i0, ov0 = nn_pruned_sorted(ga, gb, n_a, **kw)
        d1, i1, ov1 = nn_pruned_sorted(gb, ga, n_b, **kw)
        opts = dict(color_scheme=color_scheme, point_to_plane=point_to_plane,
                    d2_mode=d2_mode)
        pays = (_gather_payload(b_pts, b_col, b_nrm, i0, **opts),
                _gather_payload(a_pts, a_col, a_nrm, i1, **opts))
    overflow = ov0 | ov1

    out: typing.Dict[str, typing.Any] = {"n_a": n_a, "n_b": n_b}
    if with_boundary:
        dself, _, ov2 = nn_pruned_sorted(ga, ga, n_a, exclude_self=True, **kw)
        overflow = overflow | ov2
        sqrt_self = torch.sqrt(torch.clamp(dself, min=0.0))
        out["self_min"] = _masked_min(sqrt_self, masks[0])
        out["self_max"] = _masked_max(sqrt_self, masks[0])

    d2_normals = query_cols = (None, None)
    if point_to_plane:
        if d2_mode == "reference":
            # Positional pairing by ORIGINAL query index (SURVEY Q3).
            d2_normals = (_gather_rows(b_nrm, ga.perm),
                          _gather_rows(a_nrm, gb.perm))
        else:
            d2_normals = (pays[0]["nrm"], pays[1]["nrm"])
    if color_scheme is not None:
        query_cols = (_sorted_rows(a_col, ga.perm, a_col_sorted),
                      _sorted_rows(b_col, gb.perm, b_col_sorted))
    _reduce_pair(out, masks, (d0, d1), (ga.points, gb.points), pays,
                 d2_normals, query_cols, color_scheme=color_scheme,
                 point_to_plane=point_to_plane)
    out["nn_overflow"] = overflow
    return out


def _pair_stats_brute(
    a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm,
    *, color_scheme, point_to_plane, d2_mode, with_boundary,
) -> typing.Dict[str, typing.Any]:
    """Device reductions for one pair through the brute-force 1-NN (K5),
    in original row order (the JAX package's brute branch of
    ``pair_stats``)."""
    _check_normals(a_nrm, b_nrm, point_to_plane)
    dev = a_pts.device
    pa, pb = a_pts.shape[0], b_pts.shape[0]
    masks = (torch.arange(pa, device=dev) < n_a,
             torch.arange(pb, device=dev) < n_b)
    i0, d0 = nn_ops.nn_argmin(a_pts, b_pts)
    i1, d1 = nn_ops.nn_argmin(b_pts, a_pts)
    opts = dict(color_scheme=color_scheme, point_to_plane=point_to_plane,
                d2_mode=d2_mode)
    pays = (_gather_payload(b_pts, b_col, b_nrm, i0, **opts),
            _gather_payload(a_pts, a_col, a_nrm, i1, **opts))

    out: typing.Dict[str, typing.Any] = {"n_a": n_a, "n_b": n_b}
    if with_boundary:
        _, dself = nn_ops.nn_argmin(a_pts, a_pts, exclude_self=True)
        sqrt_self = torch.sqrt(dself)  # unclamped, as the JAX brute branch
        out["self_min"] = _masked_min(sqrt_self, masks[0])
        out["self_max"] = _masked_max(sqrt_self, masks[0])

    d2_normals = (None, None)
    if point_to_plane:
        if d2_mode == "reference":
            # SURVEY Q3: the opposite cloud's normals, positionally.
            d2_normals = (_gather_rows(b_nrm, torch.arange(pa, device=dev)),
                          _gather_rows(a_nrm, torch.arange(pb, device=dev)))
        else:
            d2_normals = (pays[0]["nrm"], pays[1]["nrm"])
    _reduce_pair(out, masks, (d0, d1), (a_pts, b_pts), pays, d2_normals,
                 (a_col, b_col), color_scheme=color_scheme,
                 point_to_plane=point_to_plane)
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
    a_nrm_sorted: typing.Optional[torch.Tensor] = None,
    b_nrm_sorted: typing.Optional[torch.Tensor] = None,
    qt8_a: typing.Optional[torch.Tensor] = None,
    qt8_b: typing.Optional[torch.Tensor] = None,
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    d2_mode: str = "reference",
    with_boundary: bool = True,
    backend: str = "jnp",
    prune_cap: typing.Optional[int] = None,
    prune_fallback: typing.Optional[int] = None,
    mxu_ok: bool = False,
    *,
    prologue: typing.Optional[str] = None,
    refine_impl: typing.Optional[str] = None,
    payload: typing.Optional[bool] = None,
    sched: typing.Optional[str] = None,
) -> typing.Dict[str, typing.Any]:
    """Device-side reductions for the full metric suite (tensors on the
    clouds' device). ``backend`` as ``nn.resolve_backend`` reads it: the
    brute force (K5) works in original order and ignores the grids and
    sorted colours; the pruned search adds ``nn_overflow``, which reports
    certificate overflow — the caller must re-run with a larger
    prune_cap/prune_fallback (by default ``nn_base_rung``'s).
    ``prologue``, ``sched``, ``refine_impl`` and ``payload`` are the pruned
    sweeps' (module docstring); with the rung, each not given is read at
    this call (``resolve_nn_schedule``). ``mxu_ok`` asserts that both
    clouds pass ``Cloud.mxu_exact``. The
    default ``backend`` is the JAX package's, "jnp", the brute force here.
    ``qt8_a``/``qt8_b`` are the JAX package's query packs, checked and
    unused (``_layout_args``)."""
    check_pack("qt8_a", qt8_a)
    check_pack("qt8_b", qt8_b)
    rows = max(a_pts.shape[0], b_pts.shape[0])
    if nn_ops.resolve_backend(backend, rows) == "brute":
        return _pair_stats_brute(
            a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm,
            color_scheme=color_scheme, point_to_plane=point_to_plane,
            d2_mode=d2_mode, with_boundary=with_boundary)
    from .grid import build_grid

    nn = resolve_nn_schedule(
        sched=sched, prologue=prologue, refine_impl=refine_impl,
        payload=payload, cap=prune_cap, fallback=prune_fallback)
    if ga is None:
        ga = build_grid(a_pts, n_a)
    if gb is None:
        gb = build_grid(b_pts, n_b)
    return _pair_stats_pruned(
        a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm, ga, gb,
        a_col_sorted, b_col_sorted, a_nrm_sorted, b_nrm_sorted,
        color_scheme=color_scheme, point_to_plane=point_to_plane,
        d2_mode=d2_mode, with_boundary=with_boundary, nn=nn, mxu_ok=mxu_ok)


def _to_host(stats: typing.Dict[str, typing.Any]) -> typing.Dict[str, np.ndarray]:
    """All device values to float64 numpy in ONE device-to-host copy."""
    keys = [k for k, v in stats.items() if isinstance(v, torch.Tensor)]
    out = {k: np.asarray(v, dtype=np.float64) for k, v in stats.items()
           if k not in keys}
    if keys:
        flat = torch.cat([stats[k].reshape(-1).to(torch.float64) for k in keys])
        with span("pcc.readback"):
            flat = flat.cpu().numpy()
        o = 0
        for k in keys:
            shape = tuple(stats[k].shape)
            size = int(np.prod(shape))
            out[k] = flat[o : o + size].reshape(shape)
            o += size
    return out


@spanned("pcc.finalize")
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


def _sorted_normals(cloud, nrm) -> typing.Optional[torch.Tensor]:
    """Per-Cloud cached Morton-sorted normals ``nrm`` (the file's or the
    estimated ones, which depend only on the cloud)."""
    if nrm is None:
        return None
    if cloud._sorted_normals is None:
        cloud._sorted_normals = nrm[cloud.get_grid().perm.long()]
    return cloud._sorted_normals


def _mxu_ok(a, b=None) -> bool:
    """Whether the expanded-norm schedules may run on these float32
    clouds (each passes ``Cloud.mxu_exact``)."""
    return all(c.points.dtype == torch.float32 and c.mxu_exact()
               for c in (a, b) if c is not None)


def boundary_stats(cloud, backend: str = "auto", *,
                   prune_cap: typing.Optional[int] = None,
                   prune_fallback: typing.Optional[int] = None,
                   prologue: typing.Optional[str] = None,
                   refine_impl: typing.Optional[str] = None,
                   sched: typing.Optional[str] = None):
    """Cached (min, max) intra-cloud NN distances of one cloud (device
    0-d tensors). They depend only on the cloud (reference:
    cloud_pair.py:108-109), so a sweep sharing one reference cloud computes
    the priciest NN pass once. ``backend`` as ``nn.resolve_backend`` reads
    it; the pruned pass escalates from (prune_cap, prune_fallback) with
    ``prologue``, ``sched`` and ``refine_impl`` (the last gated by the
    cloud's ``mxu_exact``), each not given read at this call
    (``resolve_nn_schedule``)."""
    if cloud._boundary_stats is not None:
        return cloud._boundary_stats
    if int(cloud.n) < 2:
        raise ValueError(
            "intra-cloud NN distances need at least 2 points; the cloud "
            f"has {int(cloud.n)}"
        )
    if nn_ops.resolve_backend(backend, cloud.padded_size) == "brute":
        _, d = nn_ops.nn_argmin(cloud.points, cloud.points, exclude_self=True)
    else:
        g = cloud.get_grid()
        nn = resolve_nn_schedule(
            sched=sched, prologue=prologue, refine_impl=refine_impl,
            payload=False, cap=prune_cap, fallback=prune_fallback)
        mxu_ok = nn.refine_impl != "default" and _mxu_ok(cloud)

        def run(cap, fallback):
            d, _, overflow = nn_pruned_sorted(
                g, g, cloud.n, exclude_self=True, **_sweep_kw(
                    nn._replace(cap=cap, fallback=fallback), mxu_ok))
            with span("pcc.readback"):
                overflow = bool(overflow)
            return d, overflow

        ncb = cloud.padded_size // CHUNK
        d, _ = climb(run, (nn.cap, nn.fallback), ncb, ncb)
    mask = cloud.valid_mask()
    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    cloud._boundary_stats = (_masked_min(sqrt_d, mask), _masked_max(sqrt_d, mask))
    return cloud._boundary_stats


def _prefetch_obb(a, peak):
    """The origin's pending OBB extent, overlapped with the NN passes (None
    under a user peak or with the extent cached): the hull its file's read
    started, else one started now (``obb.start_obb_extent``) and held as
    its pending extent, which ``Cloud.get_obb_extent`` resolves."""
    if peak is not None:
        return None
    if a._obb_extent is None:
        a._obb_extent = obb.start_obb_extent(a.valid_points, a.device)
    pending = isinstance(a._obb_extent, concurrent.futures.Future)
    return a._obb_extent if pending else None


# Remembers the certificate-passing (cap, fallback) rung per problem shape
# so a sweep of same-shaped pairs starts at the rung that worked instead of
# re-climbing the cheaper-but-overflowing rungs per pair. Not monotone:
# ladder_lookup retries the base rung periodically.
_LADDER_MEMO: dict = {}


def _sweep_memo_key(a, b, color_scheme, point_to_plane, d2_mode, backend,
                    nn: NnSchedule):
    """The sweeps' ladder-memo key, one for the fold and the stepwise path
    so both share rungs. The schedule is part of it: a rung that certified
    under one must not seed another's first call."""
    return (a.padded_size, b.padded_size, str(a.points.dtype), color_scheme,
            point_to_plane, d2_mode, backend, nn.refine_impl, nn.payload)


def _finish(host, a, obb_future, peak, color_scheme, point_to_plane):
    """The table from the host stats: the OBB peak (a user ``peak``, as
    pc_error's --resolution, skips the OBB entirely, and ``obb_future`` is
    None), then ``finalize_stats``."""
    if obb_future is not None:
        with span("pcc.obb_wait"):
            obb_future.result()
    extent_peak = (float(peak) if peak is not None
                   else float(np.max(a.get_obb_extent())))
    return finalize_stats(host, extent_peak, color_scheme=color_scheme,
                          point_to_plane=point_to_plane, peak=peak)


@spanned("pcc.fold")
def cold_pair_program(
    a_pts, b_pts, n_a, n_b, a_col=None, b_col=None, ga=None, gb=None,
    qt8_a=None, qt8_b=None, a_nrm=None, a_nrm_s=None, b_nrm=None, b_nrm_s=None,
    a_col_s=None, b_col_s=None, boundary_a=None,
    color_scheme=None, point_to_plane=True, d2_mode="reference",
    est_a=True, est_b=True, k=30, knn_cap=64, knn_ft=256,
    prune_cap=32, prune_fallback=256, mxu_ok=False, knn_flags=None,
    *,
    prologue: typing.Optional[str] = None,
    refine_impl: typing.Optional[str] = None,
    payload: typing.Optional[bool] = None,
    sched: typing.Optional[str] = None,
):
    """The cold-pair fold: everything a pair with (partly) cold per-cloud
    state needs, in one run of device work with no host readback.

    Builds the grids not given (``build_grid``, on the device), estimates
    the normals of each cloud that ``est_a`` / ``est_b`` asks for
    (``normals.estimation_core`` at rung (``knn_cap``, ``knn_ft``) with
    ``knn_flags``, which also gives the boundary stats), gathers the sorted
    colours not given, then runs the pruned sweeps and reductions
    (``_pair_stats_pruned``), with the self sweep only when no
    ``boundary_a`` is known. Every certificate's overflow is ORed on the
    device into ``stats["nn_overflow"]``.

    Returns ``(stats, cacheables)``, the latter the per-cloud state for the
    caller to cache. ``prologue``, ``refine_impl``, ``payload`` and
    ``sched`` are the sweeps' (``pair_stats``); each not given, and
    ``PCC_NN_P1``, is read at this call (``resolve_nn_schedule``).
    ``qt8_a``/``qt8_b`` are the JAX package's query packs, checked and
    unused (``_layout_args``).
    """
    from .grid import build_grid
    from .normals import estimation_core

    check_pack("qt8_a", qt8_a)
    check_pack("qt8_b", qt8_b)
    nn = resolve_nn_schedule(
        sched=sched, prologue=prologue, refine_impl=refine_impl,
        payload=payload, cap=prune_cap, fallback=prune_fallback)
    if ga is None:
        ga = build_grid(a_pts, n_a)
    if gb is None:
        gb = build_grid(b_pts, n_b)
    est_overflows = []
    boundary_b = None
    if est_a:
        a_nrm, a_nrm_s, mn_a, mx_a, ov_a = estimation_core(
            ga, n_a, k, knn_cap, knn_ft, knn_flags)
        boundary_a = (mn_a, mx_a)
        est_overflows.append(ov_a)
    if est_b:
        b_nrm, b_nrm_s, mn_b, mx_b, ov_b = estimation_core(
            gb, n_b, k, knn_cap, knn_ft, knn_flags)
        boundary_b = (mn_b, mx_b)
        est_overflows.append(ov_b)
    if color_scheme is not None:  # geometry-only pairs never read colours
        a_col_s = _sorted_rows(a_col, ga.perm, a_col_s)
        b_col_s = _sorted_rows(b_col, gb.perm, b_col_s)
    stats = _pair_stats_pruned(
        a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm, ga, gb,
        a_col_s, b_col_s, a_nrm_s, b_nrm_s,
        color_scheme=color_scheme, point_to_plane=point_to_plane,
        d2_mode=d2_mode, with_boundary=boundary_a is None, nn=nn,
        mxu_ok=mxu_ok)
    if boundary_a is not None:
        stats["self_min"], stats["self_max"] = boundary_a
    for ov in est_overflows:
        stats["nn_overflow"] = stats["nn_overflow"] | ov
    cacheables = {
        "ga": ga, "gb": gb, "nrm_a": a_nrm, "nrm_b": b_nrm,
        "nrm_a_s": a_nrm_s, "nrm_b_s": b_nrm_s,
        "a_col_s": a_col_s, "b_col_s": b_col_s,
        "boundary_a": (stats["self_min"], stats["self_max"]),
        "boundary_b": boundary_b,
    }
    return stats, cacheables


def _needs_est(c) -> bool:
    return c.normals is None and c._est_normals is None


def _cold_device_state(a, b, color_scheme) -> bool:
    """Whether either cloud still lacks a grid, or sorted colours that the
    sweeps will read."""
    for c in (a, b):
        if c._grid is None:
            return True
        if (color_scheme is not None and c.colors is not None
                and c._sorted_colors is None):
            return True
    return False


def _cold_fold_applicable(a, b, color_scheme, point_to_plane, backend) -> bool:
    """The JAX package's rule for the fold: pruned pairs of clouds at or
    above the estimation's pruning threshold and of one dtype, in which a
    cloud needs normal estimation (and both hold at least k points), or a
    cloud's grid or sorted colours are not built yet (and the origin holds
    two points). Warm pairs and every other case stay stepwise."""
    from .normals import DEFAULT_KNN, _PRUNE_THRESHOLD

    if (backend != "pruned"
            or min(a.padded_size, b.padded_size) < _PRUNE_THRESHOLD
            or a.points.dtype != b.points.dtype):
        return False
    if point_to_plane and (_needs_est(a) or _needs_est(b)):
        return min(int(a.n), int(b.n)) >= max(DEFAULT_KNN, 2)
    return _cold_device_state(a, b, color_scheme) and int(a.n) >= 2


def _fused_evaluate_cold(a, b, color_scheme, point_to_plane, d2_mode, peak,
                         nn: NnSchedule, mxu_ok: bool):
    """``fused_evaluate`` through the fold on the resolved schedule ``nn``:
    ``cold_pair_program`` and one readback (``_to_host``), with the OBB on
    a thread beside it. Returns None when a certificate overflowed (the
    caller reruns stepwise, with its ladders; the OBB stays pending).

    The rung rules are the JAX package's: the sweeps' rung from the fused
    ladder memo (the stepwise path's key, so both share rungs); both
    estimations at max(rung_a, rung_b) of the estimation memo, the rung
    stored only under the shape that demanded it; nothing stored on
    overflow. On success each cloud caches what the stepwise path would:
    grid, estimated and sorted normals, sorted colours, boundary stats.
    """
    from .knn_pruned import knn_flags_from_env
    from .normals import DEFAULT_KNN, knn_base_rung
    from .normals import _LADDER_MEMO as _EST_MEMO

    obb_future = _prefetch_obb(a, peak)
    memo_key = _sweep_memo_key(a, b, color_scheme, point_to_plane, d2_mode,
                               "pruned", nn)
    cap, fallback = ladder_lookup(_LADDER_MEMO, memo_key,
                                  (nn.cap, nn.fallback))

    def nrm_state(c):
        # Only CACHED sorted normals are passed in: the sweeps read them on
        # the payload schedule alone.
        if c.normals is not None:
            return c.normals, c._sorted_normals, False
        if c._est_normals is not None:
            return c._est_normals, c._sorted_normals, False
        return None, None, point_to_plane

    a_nrm, a_nrm_s, est_a = nrm_state(a)
    b_nrm, b_nrm_s, est_b = nrm_state(b)
    kcap = kft = kflags = None
    if est_a or est_b:
        kflags = knn_flags_from_env()
        base = knn_base_rung()
        rung_a = ladder_lookup(_EST_MEMO, (a.padded_size, DEFAULT_KNN), base)
        rung_b = ladder_lookup(_EST_MEMO, (b.padded_size, DEFAULT_KNN), base)
        kcap, kft = max(rung_a[0], rung_b[0]), max(rung_a[1], rung_b[1])
    stats, cache = cold_pair_program(
        a.points, b.points, a.n, b.n, a.colors, b.colors, a._grid, b._grid,
        a_nrm=a_nrm, a_nrm_s=a_nrm_s, b_nrm=b_nrm, b_nrm_s=b_nrm_s,
        a_col_s=a._sorted_colors, b_col_s=b._sorted_colors,
        boundary_a=a._boundary_stats, color_scheme=color_scheme,
        point_to_plane=point_to_plane, d2_mode=d2_mode, est_a=est_a,
        est_b=est_b, k=DEFAULT_KNN, knn_cap=kcap or 64, knn_ft=kft or 256,
        prune_cap=cap, prune_fallback=fallback, mxu_ok=mxu_ok,
        knn_flags=kflags, prologue=nn.prologue, refine_impl=nn.refine_impl,
        payload=nn.payload, sched=nn.sched)
    host = _to_host(stats)  # the one round trip: results and overflow
    if bool(host["nn_overflow"]):
        return None
    ladder_store(_LADDER_MEMO, memo_key, (cap, fallback))
    if est_a and rung_a == (kcap, kft):
        ladder_store(_EST_MEMO, (a.padded_size, DEFAULT_KNN), (kcap, kft))
    if est_b and rung_b == (kcap, kft):
        ladder_store(_EST_MEMO, (b.padded_size, DEFAULT_KNN), (kcap, kft))
    a._grid, b._grid = cache["ga"], cache["gb"]
    if est_a:
        a._est_normals, a._sorted_normals = cache["nrm_a"], cache["nrm_a_s"]
    if est_b:
        b._est_normals, b._sorted_normals = cache["nrm_b"], cache["nrm_b_s"]
    if cache["a_col_s"] is not None:
        a._sorted_colors = cache["a_col_s"]
    if cache["b_col_s"] is not None:
        b._sorted_colors = cache["b_col_s"]
    a._boundary_stats = cache["boundary_a"]
    if cache["boundary_b"] is not None and b._boundary_stats is None:
        b._boundary_stats = cache["boundary_b"]
    return _finish(host, a, obb_future, peak, color_scheme, point_to_plane)


@spanned("pcc.evaluate")
def fused_evaluate(
    a, b, color_scheme=None, point_to_plane=False, d2_mode="reference",
    backend: str = "auto", peak: typing.Optional[float] = None, *,
    prune_cap: typing.Optional[int] = None,
    prune_fallback: typing.Optional[int] = None,
) -> typing.Dict[str, np.float64]:
    """Full fused evaluation of a Cloud pair on the clouds' device.

    ``backend``: "auto" takes the brute force (K5, no grids, no ladder)
    below ``nn.PRUNE_THRESHOLD`` padded rows and the pruned search at or
    above it; "brute" (aliases "pallas", "jnp") and "pruned" force one.
    ``prune_cap``/``prune_fallback`` are the base rung of the pruned
    search's certificate ladder; an overflowing rung escalates through
    ``next_rung`` (one synchronous overflow readback per attempt), and the
    ladder remembers its rung per shape and refine schedule. The sweeps'
    schedule and the rung not given are read once, at this call (module
    docstring); the estimation's (``PCC_KNN_*``) at its own calls.
    """
    nn = resolve_nn_schedule(cap=prune_cap, fallback=prune_fallback)
    backend = nn_ops.resolve_backend(backend,
                                     max(a.padded_size, b.padded_size))
    if a.device != b.device or a.points.dtype != b.points.dtype:
        raise ValueError("both clouds must share one device and dtype")
    if point_to_plane and d2_mode == "reference" and a.n > b.n:
        raise IndexError(
            "reference D2 mode requires n_origin <= n_reconst "
            f"(got {a.n} > {b.n}); use d2_mode='pc_error'"
        )
    mxu_ok = (backend == "pruned" and nn.refine_impl != "default"
              and _mxu_ok(a, b))
    if _cold_fold_applicable(a, b, color_scheme, point_to_plane, backend):
        out = _fused_evaluate_cold(
            a, b, color_scheme, point_to_plane, d2_mode, peak, nn, mxu_ok)
        if out is not None:
            return out
        # A certificate overflowed in the fold: the stepwise path below
        # reruns with its per-stage ladders.
    obb_future = _prefetch_obb(a, peak)
    a_nrm, b_nrm = a.normals, b.normals
    if point_to_plane:
        # Per-cloud cache: estimated normals depend only on the cloud.
        a_nrm, b_nrm = a.get_normals(), b.get_normals()
    if int(a.n) < 2 and a._boundary_stats is None:
        raise ValueError(
            "intra-cloud NN distances need at least 2 points; the cloud "
            f"has {int(a.n)}"
        )
    # The self-NN pass is folded in when the origin's boundary stats are
    # not cached yet (a normal estimation above may have just cached them);
    # the result is cached either way.
    with_boundary = a._boundary_stats is None
    kwargs = dict(color_scheme=color_scheme, point_to_plane=point_to_plane,
                  d2_mode=d2_mode, with_boundary=with_boundary)

    ga = gb = a_col_sorted = b_col_sorted = a_nrm_sorted = b_nrm_sorted = None
    if backend == "pruned":
        ga, gb = a.get_grid(), b.get_grid()
        if color_scheme is not None:
            a_col_sorted = _sorted_colors(a)
            b_col_sorted = _sorted_colors(b)
        if point_to_plane and nn.payload:
            a_nrm_sorted = _sorted_normals(a, a_nrm)
            b_nrm_sorted = _sorted_normals(b, b_nrm)

    def run(cap=None, fallback=None):
        args = (a.points, b.points, a.n, b.n, a.colors, b.colors, a_nrm,
                b_nrm)
        if backend == "brute":
            stats = _pair_stats_brute(*args, **kwargs)
        else:
            stats = _pair_stats_pruned(
                *args, ga, gb, a_col_sorted, b_col_sorted, a_nrm_sorted,
                b_nrm_sorted, nn=nn._replace(cap=cap, fallback=fallback),
                mxu_ok=mxu_ok, **kwargs)
        if not with_boundary:
            stats["self_min"], stats["self_max"] = a._boundary_stats
        host = _to_host(stats)  # one round-trip: results + overflow
        return (stats, host), bool(host.get("nn_overflow", False))

    if backend == "brute":
        (stats, host), _ = run()
    else:
        memo_key = _sweep_memo_key(a, b, color_scheme, point_to_plane,
                                   d2_mode, backend, nn)
        n_chunks = max(a.padded_size, b.padded_size) // CHUNK
        (stats, host), _ = climb(run, (nn.cap, nn.fallback), n_chunks,
                                 n_chunks, _LADDER_MEMO, memo_key)
    if with_boundary:
        a._boundary_stats = (stats["self_min"], stats["self_max"])
    return _finish(host, a, obb_future, peak, color_scheme, point_to_plane)
