"""Bound-pruned exact k-NN over Morton chunk grids (normal estimation at scale).

Port of the default count-gated schedule of
``open_pcc_metric_tpu/ops/knn_pruned.py`` (``KnnFlags()``: sched "counted",
p1 = 8, one slot per step, no sorted-slice or two-level extension, the
plain lower-bound prologue). The structure is ``nn_pruned``'s with a k-best
selection: each 256-query tile refines a prefix of its lowest-lower-bound
chunks, then certifies itself with ub = max over its valid queries of the
k-th refined distance; tiles that fail are re-refined in two wider tiers,
and only if those fail too does the call report ``overflow``.

Every refine goes through ``refine.refine_knn`` (K3), whose merge keeps the
lexicographic (distance, original index) k-best whatever the visit order,
so the k-set equals every other exact backend's, ties included. With
``with_moments`` a second pass, ``refine.knn_moments`` (K4), sums the
query-relative offsets of each query's k-NN set over the same candidate
schedule: the normal estimation needs only those sums, never a (P, k, 3)
neighbour gather.

The JAX package's need-sorted slices (``_ext_sorted_slices``,
``_mom_sorted_slices``) and two-level extension (``_ext_two_level``) are
TPU scheduling devices with the same results; the port runs the plain
rectangular, count-gated form.
"""
from __future__ import annotations

import typing

import torch

from .grid import CHUNK, ChunkGrid, build_grid
from .nn_pruned import stable_top, tile_bounds, unsort_rows
from .refine import MOM_CH, knn_moments, refine_knn
from ..utils.cache import ladder_lookup, ladder_store, next_rung


def knn_pruned_sorted(
    ga: ChunkGrid,
    gb: ChunkGrid,
    n_a: int,
    k: int,
    exclude_self: bool = False,
    cap: int = 32,
    fallback_tiles: int = 128,
    with_moments: bool = False,
    p1: int = 8,
) -> typing.Tuple[torch.Tensor, ...]:
    """k-NN in Morton-sorted query order; ORIGINAL neighbour indices.

    ``n_a`` is the query cloud's valid count (sorted row s is valid iff
    s < n_a). Returns ``(dist_sq (P, k), idx (P, k) int32, overflow 0-d
    bool tensor)``, ascending by distance; with ``with_moments`` a fourth
    output, (P, MOM_CH) sums [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz,
    syz] of the offsets from each query to its k neighbours (of a
    self-inclusive k-NN, the estimation's: not with ``exclude_self``).

    Schedule: a probe of the ``p1`` lowest-lb chunks of every tile, a
    certificate count from the k-th distance, an in-place extension of
    each tile to min(count, cap) chunks seeded from the probe (gated per
    tile), then tier A (the top ``fallback_tiles`` tiles by count, widened
    to cap2a = min(max(2 cap, 128), ncb)) and tier B (the worst of those,
    widened to cap2b = min(max(8 cap, 512, ncb // 4), ncb)), both seeded,
    gated and read in place through global tile ids. With cap <= 8 stage 1
    is one refine of all ``cap`` chunks. The moments pass walks the same
    prefixes: min(count, cap) chunks of every tile, then each tier's
    extension, with the count taken from the final k-th distances.
    """
    if with_moments and exclude_self:
        raise ValueError("with_moments sums a self-inclusive k-NN set; "
                         "exclude_self is not supported with it")
    n_a = int(n_a)
    dtype = ga.points.dtype
    eps = torch.finfo(dtype).eps
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    cap = min(cap, ncb)

    valid_t, lb, order = tile_bounds(ga, gb, n_a)

    def refine(cand, **kw):
        return refine_knn(ga.points, gb.points, gb.perm, cand.contiguous(), k,
                          exclude_self=exclude_self, **kw)

    def cert_counts(dk, tlb, tvalid):
        ub = torch.where(tvalid, dk[:, :, k - 1], -torch.inf).amax(dim=1)
        ub_eff = ub * (1 + 8 * eps) + 8 * eps
        return (tlb <= ub_eff[:, None]).sum(dim=1, dtype=torch.int32)

    if cap > 8:
        p1 = max(1, min(p1, cap - 1))
        d1, i1 = refine(order[:, :p1])
        counts1 = cert_counts(d1, lb, valid_t)
        ncand2 = torch.clamp(counts1 - p1, 0, cap - p1).to(torch.int32)
        dk, ik = refine(order[:, p1:cap], ncand=ncand2, init=(d1, i1))
    else:
        dk, ik = refine(order[:, :cap])

    # ---- stage-1 certificate on the k-th distance
    counts = cert_counts(dk, lb, valid_t)
    ft = min(fallback_tiles, nta)
    cap2a = min(max(2 * cap, 128), ncb)
    cap2b = min(max(8 * cap, 512, ncb // 4), ncb)
    overflow = (counts > cap).sum() > ft

    def tier(tiles, tcounts, lo, hi):
        """Re-refine ``tiles`` (global ids) in place of their rows, seeded
        with their current k-buffers: each executes only its chunks beyond
        the already-refined lb-prefix of width ``lo``, up to
        min(count, hi)."""
        nonlocal dk, ik
        ncand = torch.where(
            tcounts > lo, torch.clamp(tcounts, max=hi) - lo, 0
        ).to(torch.int32)
        fd, fi = refine(order[tiles, lo:hi], tiles=tiles.to(torch.int32),
                        ncand=ncand, init=(dk[tiles].contiguous(),
                                           ik[tiles].contiguous()))
        dk = dk.index_copy(0, tiles, fd)
        ik = ik.index_copy(0, tiles, fi)
        return cert_counts(fd, lb[tiles], valid_t[tiles])

    tiers = []  # (tiles, lo, hi) of each tier that ran
    if ft > 0 and cap2a > cap:
        otiles = stable_top(counts, ft)
        counts2a = tier(otiles, counts[otiles], cap, cap2a)
        tiers.append((otiles, cap, cap2a))
        ft2 = min(max(ft // 8, 16), ft)
        if cap2b > cap2a:
            need_b = torch.where(counts2a > cap2a, counts2a, 0)
            overflow = overflow | ((need_b > 0).sum() > ft2)
            bsel = stable_top(need_b, ft2)
            btiles = otiles[bsel]
            counts2b = tier(btiles, need_b[bsel], cap2a, cap2b)
            tiers.append((btiles, cap2a, cap2b))
            overflow = overflow | (counts2b > cap2b).any()
        else:
            overflow = overflow | (counts2a > cap2a).any()

    p = nta * CHUNK
    if not with_moments:
        return dk.reshape(p, k), ik.reshape(p, k), overflow

    # ---- moment sums of the exact k-NN sets. Members are the pairs
    # lexicographically <= the k-buffer's last slot, which is the k-set
    # the merge kept. Gate: the final certificate count covers every
    # member's chunk (member d <= r_k <= ub_eff, so its chunk's lb
    # qualifies), and the lb-ascending prefix of that width holds them all.
    rk = dk[:, :, k - 1].contiguous()
    rid = ik[:, :, k - 1].contiguous()
    countsf = cert_counts(dk, lb, valid_t)
    mom = knn_moments(ga.points, gb.points, gb.perm,
                      order[:, :cap].contiguous(),
                      torch.clamp(countsf, max=cap).to(torch.int32), rk, rid)
    for tiles, lo, hi in tiers:
        # Extend the compacted tiles' sums past the prefix already summed.
        cf = countsf[tiles]
        ncm = torch.where(cf > lo, torch.clamp(cf, max=hi) - lo, 0)
        part = knn_moments(ga.points, gb.points, gb.perm,
                           order[tiles, lo:hi].contiguous(),
                           ncm.to(torch.int32), rk[tiles].contiguous(),
                           rid[tiles].contiguous(),
                           tiles=tiles.to(torch.int32),
                           init=mom[tiles].contiguous())
        mom = mom.index_copy(0, tiles, part)
    return (dk.reshape(p, k), ik.reshape(p, k), overflow,
            mom.reshape(p, MOM_CH))


# Remembers the (cap, fallback_tiles) rung that certified per problem
# shape, with the periodic base-rung retry of utils.cache.ladder_lookup.
_ESCALATION_MEMO: dict = {}


def knn_pruned(
    a_points: torch.Tensor,
    b_points: torch.Tensor,
    n_a: int,
    n_b: int,
    k: int,
    exclude_self: bool = False,
    cap: int = 64,
    fallback_tiles: int = 256,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Exact pruned k-NN in ORIGINAL order with automatic escalation.

    Returns ``(idx int32 (Pa, k), dist_sq (Pa, k))`` ascending by distance.
    """
    nta = a_points.shape[0] // CHUNK
    ncb = b_points.shape[0] // CHUNK
    key = (a_points.shape[0], b_points.shape[0], k, exclude_self)
    cap, fallback_tiles = ladder_lookup(
        _ESCALATION_MEMO, key, (cap, fallback_tiles))
    ga = build_grid(a_points, int(n_a))
    gb = ga if exclude_self or a_points is b_points else build_grid(
        b_points, int(n_b))
    while True:
        dk, ik, overflow = knn_pruned_sorted(
            ga, gb, n_a, k, exclude_self=exclude_self, cap=cap,
            fallback_tiles=fallback_tiles)
        # Exact iff the certificate passed or stage 1 refined every chunk.
        if not bool(overflow) or cap >= ncb:
            ladder_store(_ESCALATION_MEMO, key, (cap, fallback_tiles))
            return unsort_rows(ga, ik), unsort_rows(ga, dk)
        cap, fallback_tiles = next_rung(cap, fallback_tiles, ncb, nta)
