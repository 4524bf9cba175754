"""Bound-pruned exact nearest-neighbour search over Morton chunk grids.

Port of the default count-gated schedule of
``open_pcc_metric_tpu/ops/nn_pruned.py`` ``nn_pruned_sorted``, and of its
original-order wrappers with the escalation ladder (``nn_pruned``,
``nn_pruned_with_grids``). Each
256-query Morton tile refines only its lowest-lower-bound search chunks,
then proves itself exact with a sound certificate:

  * lb(tile, chunk) = bbox-to-bbox squared distance lower-bounds every
    query-candidate pair;
  * after refining a prefix of the tile's lb-ascending chunk order, the
    tile's ub = max over its VALID queries of the refined distance;
  * qualifying count = #{chunks with lb <= ub}. If the count fits the
    refined prefix, every chunk that could hold a nearer point was refined.

Tiles that fail are re-refined in two wider tiers; only if those fail too
does the call report ``overflow`` and the caller escalate — exactness is
never silently lost. Every refine goes through ``refine.refine_nn`` (K1).

The candidate order is a total order: a stable sort of each lb row, so
equal lbs keep ascending chunk index — what XLA's ``top_k`` gives, and what
the tiers' skip-the-refined-prefix step relies on (``torch.topk`` promises
no order among ties). Tier tiles are picked by a stable descending sort the
same way.
"""
from __future__ import annotations

import typing

import torch

from .grid import CHUNK, ChunkGrid, bbox_lower_bounds, build_grid
from .refine import refine_nn
from ..utils.cache import ladder_lookup, ladder_store, next_rung


def stable_top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, ties to the lower
    index (XLA ``top_k`` order), as int64."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def tile_bounds(ga: ChunkGrid, gb: ChunkGrid, n_a: int):
    """(valid_t, lb, order): the (nta, 256) validity mask of the query rows,
    the (nta, ncb) bbox lower bounds over VALID query rows, and each row's
    chunks in ascending-lb order (stable, int32)."""
    dtype = ga.points.dtype
    big = torch.finfo(dtype).max
    nta = ga.points.shape[0] // CHUNK
    a_tiles = ga.points.reshape(nta, CHUNK, 3)
    valid_t = (torch.arange(nta * CHUNK, device=ga.points.device)
               < n_a).reshape(nta, CHUNK)
    a_lo = torch.where(valid_t[:, :, None], a_tiles, big).amin(dim=1)
    a_hi = torch.where(valid_t[:, :, None], a_tiles, -big).amax(dim=1)
    lb = bbox_lower_bounds(a_lo, a_hi, gb.bbox_lo, gb.bbox_hi)
    order = torch.sort(lb, dim=1, stable=True).indices.to(torch.int32)
    return valid_t, lb, order


def nn_pruned_sorted(
    ga: ChunkGrid,
    gb: ChunkGrid,
    n_a: int,
    exclude_self: bool = False,
    cap: int = 32,
    fallback_tiles: int = 128,
    p1: int = 8,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-NN in Morton-sorted query order.

    ``n_a`` is the query cloud's valid count: sorted row s is valid iff
    s < n_a. Returns ``(dist_sq (Pa,), idx_into_ORIGINAL_b (Pa,) int32,
    overflow 0-d bool tensor)``. Sentinel query rows return meaningless
    (finite) distances — callers mask by row < n_a.

    Schedule (the JAX package's default): a probe of the ``p1`` lowest-lb
    chunks of every tile, a certificate count from its ub, an in-place
    extension of each tile to min(count, cap) chunks seeded from the probe
    (gated per tile), then tier A (the top ``fallback_tiles`` tiles by
    count, widened to cap2a) and tier B (the worst of those, widened to
    cap2b), both seeded and gated. With cap <= 8 stage 1 is one refine of
    all ``cap`` chunks.
    """
    dtype = ga.points.dtype
    eps = torch.finfo(dtype).eps
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    cap = min(cap, ncb)

    valid_t, lb, order = tile_bounds(ga, gb, n_a)

    def refine(cand, **kw):
        return refine_nn(ga.points, gb.points, gb.perm, cand.contiguous(),
                         exclude_self=exclude_self, **kw)

    def cert_counts(d, tlb, tvalid):
        ub = torch.where(tvalid, d, -torch.inf).amax(dim=1)
        ub_eff = ub * (1 + 8 * eps) + 8 * eps
        return (tlb <= ub_eff[:, None]).sum(dim=1, dtype=torch.int32)

    if cap > 8:
        p1 = max(1, min(p1, cap - 1))
        d1, i1 = refine(order[:, :p1])
        counts1 = cert_counts(d1, lb, valid_t)
        ncand2 = torch.clamp(counts1 - p1, 0, cap - p1).to(torch.int32)
        dmin, gidx = refine(order[:, p1:cap], ncand=ncand2, init=(d1, i1))
    else:
        dmin, gidx = refine(order[:, :cap])

    # ---- stage-1 exactness certificate
    counts = cert_counts(dmin, lb, valid_t)
    ft = min(fallback_tiles, nta)
    cap2a = min(max(4 * cap, 128), ncb)
    cap2b = min(max(16 * cap, 512, ncb // 4), ncb)
    overflow = (counts > cap).sum() > ft

    def tier(tiles, tcounts, lo, hi):
        """Re-refine ``tiles`` (global ids) in place of their rows, seeded
        with their current rows: each executes only its chunks beyond the
        already-refined lb-prefix of width ``lo``, up to min(count, hi)."""
        nonlocal dmin, gidx
        ncand = torch.where(
            tcounts > lo, torch.clamp(tcounts, max=hi) - lo, 0
        ).to(torch.int32)
        tiles32 = tiles.to(torch.int32)
        fd, fi = refine(order[tiles, lo:hi], tiles=tiles32, ncand=ncand,
                        init=(dmin[tiles].contiguous(),
                              gidx[tiles].contiguous()))
        dmin = dmin.index_copy(0, tiles, fd)
        gidx = gidx.index_copy(0, tiles, fi)
        return cert_counts(fd, lb[tiles], valid_t[tiles])

    if ft > 0 and cap2a > cap:
        # Tier A: every over-cap tile lands here when n_over <= ft.
        otiles = stable_top(counts, ft)
        counts2a = tier(otiles, counts[otiles], cap, cap2a)
        ft2 = min(max(ft // 8, 16), ft)
        if cap2b > cap2a:
            # Tier B: the few tiles whose qualifying set exceeds tier A's
            # width (counts against tier-A results are sound: ub only
            # shrinks with more refinement).
            need_b = torch.where(counts2a > cap2a, counts2a, 0)
            overflow = overflow | ((need_b > 0).sum() > ft2)
            bsel = stable_top(need_b, ft2)
            counts2b = tier(otiles[bsel], need_b[bsel], cap2a, cap2b)
            overflow = overflow | (counts2b > cap2b).any()
        else:
            overflow = overflow | (counts2a > cap2a).any()

    return dmin.reshape(nta * CHUNK), gidx.reshape(nta * CHUNK), overflow


def unsort_rows(g: ChunkGrid, x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` from Morton-sorted order back to original row order."""
    p = x.shape[0]
    inv = torch.empty(p, dtype=torch.long, device=x.device)
    inv[g.perm.long()] = torch.arange(p, device=x.device)
    return x[inv]


def unsort_nn_result(
    ga: ChunkGrid, gb: ChunkGrid, d_sorted: torch.Tensor, i_sorted: torch.Tensor
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Map sorted-query-order (dist, orig-b-idx) back to original row order."""
    return unsort_rows(ga, d_sorted), unsort_rows(ga, i_sorted)


def nn_pruned_with_grids(
    ga: ChunkGrid,
    gb: ChunkGrid,
    n_a: int,
    exclude_self: bool = False,
    cap: int = 32,
    fallback_tiles: int = 128,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Pruned 1-NN over prebuilt grids, ORIGINAL order, with escalation.

    Returns ``(idx int32 (Pa,), dist_sq (Pa,))``. Building the grids once
    per cloud (``Cloud.get_grid``) shares the Morton sort across every NN
    pass of an evaluation.
    """
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    while True:
        d_s, i_s, overflow = nn_pruned_sorted(
            ga, gb, n_a, exclude_self=exclude_self, cap=cap,
            fallback_tiles=fallback_tiles)
        # Exact iff the certificate passed, or stage 1 refined every chunk.
        if not bool(overflow) or cap >= ncb:
            d, idx = unsort_nn_result(ga, gb, d_s, i_s)
            return idx, d
        cap, fallback_tiles = next_rung(cap, fallback_tiles, ncb, nta)


# Remembers the (cap, fallback_tiles) rung that certified per problem shape,
# with the periodic base-rung retry of utils.cache.ladder_lookup.
_ESCALATION_MEMO: dict = {}


def nn_pruned(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    n_a: int,
    n_b: int,
    exclude_self: bool = False,
    cap: int = 32,
    fallback_tiles: int = 128,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Exact pruned 1-NN in ORIGINAL row order with automatic escalation.

    Returns ``(idx int32 (Pa,), dist_sq (Pa,))``. With ``exclude_self``
    the search runs over ``a`` itself (``b_points`` is not read). An
    overflowing rung escalates through ``next_rung`` until the certificate
    passes or stage 1 covers every search chunk; the rung that worked is
    remembered per problem shape.
    """
    nta = a_points.shape[0] // CHUNK
    ncb = b_points.shape[0] // CHUNK
    key = (a_points.shape[0], b_points.shape[0], exclude_self)
    cap, fallback_tiles = ladder_lookup(
        _ESCALATION_MEMO, key, (cap, fallback_tiles))
    ga = build_grid(a_points, int(n_a))
    gb = ga if exclude_self else build_grid(b_points, int(n_b))
    while True:
        d_s, i_s, overflow = nn_pruned_sorted(
            ga, gb, int(n_a), exclude_self=exclude_self, cap=cap,
            fallback_tiles=fallback_tiles)
        if not bool(overflow) or cap >= ncb:
            ladder_store(_ESCALATION_MEMO, key, (cap, fallback_tiles))
            d, idx = unsort_nn_result(ga, gb, d_s, i_s)
            return idx, d
        cap, fallback_tiles = next_rung(cap, fallback_tiles, ncb, nta)
