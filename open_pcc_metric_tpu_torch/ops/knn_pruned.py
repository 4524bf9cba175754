"""Bound-pruned exact k-NN over Morton chunk grids (normal estimation at scale).

Port of ``open_pcc_metric_tpu/ops/knn_pruned.py``. The structure is
``nn_pruned``'s with a k-best selection: each 256-query tile refines a
prefix of its lowest-lower-bound chunks, then certifies itself with ub =
max over its valid queries of the k-th refined distance; tiles that fail
are re-refined in two wider tiers, and only if those fail too does the
call report ``overflow``.

Every refine goes through ``refine.refine_knn`` (K3), whose merge keeps the
lexicographic (distance, original index) k-best whatever the visit order,
so the k-set equals every other exact backend's, ties included. With
``with_moments`` a second pass, ``refine.knn_moments`` (K4), sums the
query-relative offsets of each query's k-NN set over the same candidate
schedule (given the search grid's chunk boxes, so the kernel can skip
slots): the normal estimation needs only those sums, never a (P, k, 3)
neighbour gather. A self-exclusive k-NN (``exclude_self``) sums them from
a gather of its k neighbours instead, as the JAX package does.

Stage 1 runs one of two schedules, chosen per call (``sched``; the public
entry points read ``PCC_KNN_SCHED``): "counted" (the probe and the gated,
seeded extension) when cap > 8 and the tiles fill whole 8-tile groups,
the JAX package's conditions, else "fixed": the lb matrix, K2c's ``cap``
candidates and one ungated, unseeded K3b launch over every tile
(``refine.refine_knn_straight``, given the search grid's chunk boxes so
the kernel can skip slots). K2c repeats column 0 on the rows of
tiles without a valid query, so K3b keeps repeated points there: those
rows are discarded. The tiers and the moments pass walk the same prefixes
on either schedule.

The stage-1 candidates and counts come from one of ``nn_pruned``'s two
prologues, chosen per call (``prologue``; the public entry points read
``PCC_KNN_PROLOGUE``): the lb matrix ("xla", the default) or K2a/K2b
("select", on the counted schedule of a float32 cloud with a whole number
of 8-tile groups, the JAX package's gate). In select mode the tiers refine
their full true-lb prefix, seeded, and the moments of every tier tile that
stage 1 did not cover are summed again from zero over that prefix (the
rounded stage-1 order shares no prefix with it, so extending would count
chunks twice). For the same reason a select-mode tier skips the chunks its
tiles have already refined: K3 merges a seed with chunks it has not seen
(the TPU kernel's merge also absorbs a re-visit; the port's register
insertion would keep a second copy).

The schedule knobs are the JAX package's ``KnnFlags``, resolved at each
call (``knn_flags_from_env``: ``PCC_KNN_SCHED``, ``PCC_KNN_P1`` and
``PCC_KNN_PROLOGUE``, which pick a schedule here, and ``PCC_KNN_CS``,
``PCC_KNN_EXT_SLICE``, ``PCC_KNN_EXT_SORTED``, ``PCC_KNN_MOM_SORTED``,
``PCC_KNN_EXT_E1`` and ``PCC_KNN_EXT_FTE``, parsed as the JAX package
parses them). The last six choose the JAX package's need-sorted slices
(``_ext_sorted_slices``, ``_mom_sorted_slices``) and two-level extension
(``_ext_two_level``): relayouts of the TPU grid, whose results are the
rectangular launch's bit for bit. K3 and K4 read every tile through
global tile ids and their gates skip dead slots, which is what the slices
buy on the TPU, so the port always runs the one rectangular, count-gated
extension and moments launch; on the H100 every sliced or two-level form
measured slower than it (PERF.md). The flags are carried so that a caller
may pass the JAX package's ``KnnFlags``.

``refine_impl`` names the JAX package's two routes. "auto", "pallas" and
"pallas_interpret" take its kernel route, the counted schedule where its
conditions hold. "xla" takes its plain route's schedule: stage 1 refines
every tile's ``cap`` candidates at once (the fixed schedule's K2c and
K3b), the tiers follow, and K4 sums the moments, as on the kernel route.
Either way each kernel runs on CUDA tensors and its plain version on CPU
tensors.
"""
from __future__ import annotations

import os
import typing

import torch

from .grid import CHUNK, ChunkGrid, build_grid
from .nn_pruned import (
    KNN_P1_ENV, KNN_PROLOGUE_ENV, KNN_SCHED_ENV, cert_ub, count_under,
    resolve_knn_sched, resolve_prologue, run_prologue, stable_top,
    tier_table, unsort_rows, uses_select)
from .refine import MOM_CH, knn_moments, refine_knn, refine_knn_straight
from ..utils.cache import climb
from ..utils.profiling import span

# refine_impl values: the JAX package's kernel route, then its plain route.
KERNEL_ROUTE = ("auto", "pallas", "pallas_interpret")
REFINE_IMPLS = KERNEL_ROUTE + ("xla",)


class KnnFlags(typing.NamedTuple):
    """The k-NN schedule knobs, the JAX package's nine fields in its order
    and with its defaults. ``sched``, ``p1`` and ``prologue`` pick the
    schedule; the other six are the TPU grid's relayouts and change no
    launch here (module docstring)."""

    sched: str = "counted"
    p1: int = 8
    ext_cs: int = 1
    ext_slice: int = 512
    ext_sorted: bool = False
    mom_sorted: bool = True
    ext_e1: int = 0
    ext_fte: int = 0
    prologue: str = "xla"


def knn_flags_from_env() -> KnnFlags:
    """The ``PCC_KNN_*`` knobs read NOW, parsed as the JAX package parses
    them: ``ext_slice`` = max(8, v // 8 * 8), ``mom_sorted`` on unless
    ``PCC_KNN_MOM_SORTED`` is set to anything but "1"."""
    env = os.environ.get
    return KnnFlags(
        sched=env(KNN_SCHED_ENV, "counted"),
        p1=int(env(KNN_P1_ENV, "8")),
        ext_cs=int(env("PCC_KNN_CS", "1")),
        ext_slice=max(8, int(env("PCC_KNN_EXT_SLICE", "512")) // 8 * 8),
        ext_sorted=env("PCC_KNN_EXT_SORTED", "0") == "1",
        mom_sorted=env("PCC_KNN_MOM_SORTED", "1") == "1",
        ext_e1=int(env("PCC_KNN_EXT_E1", "0")),
        ext_fte=int(env("PCC_KNN_EXT_FTE", "0")),
        prologue=env(KNN_PROLOGUE_ENV, "xla"),
    )


def resolve_knn_flags(flags: typing.Optional[KnnFlags] = None, *,
                      p1: typing.Optional[int] = None,
                      prologue: typing.Optional[str] = None,
                      sched: typing.Optional[str] = None) -> KnnFlags:
    """``flags`` (``knn_flags_from_env()`` when None) with each of ``p1``,
    ``prologue`` and ``sched`` that is given in place of its field (the
    last two checked, as ``resolve_prologue`` and ``resolve_knn_sched``
    check them)."""
    flags = knn_flags_from_env() if flags is None else flags
    over = {}
    if p1 is not None:
        over["p1"] = int(p1)
    if prologue is not None:
        over["prologue"] = resolve_prologue(prologue, KNN_PROLOGUE_ENV)
    if sched is not None:
        over["sched"] = resolve_knn_sched(sched)
    return flags._replace(**over) if over else flags


def _mark(seen, cand, live):
    """``seen`` (rows, ncb) with each row's first ``live`` chunks of
    ``cand`` added."""
    pos = torch.arange(cand.shape[1], device=cand.device)
    return seen | torch.zeros_like(seen).scatter_(
        1, cand.long(), pos < live[:, None])


def _unseen(cand, live, seen):
    """Each row's first ``live`` chunks of ``cand`` that ``seen`` does not
    hold, moved to the front in their order, and how many there are."""
    pos = torch.arange(cand.shape[1], device=cand.device)
    keep = (pos < live[:, None]) & ~seen.gather(1, cand.long())
    front = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    return cand.gather(1, front), keep.sum(dim=1, dtype=torch.int32)


def gather_moments(ga: ChunkGrid, gb: ChunkGrid, dk: torch.Tensor,
                   ik: torch.Tensor) -> torch.Tensor:
    """(P, MOM_CH) sums [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz] of
    the offsets from each sorted query to its k neighbours ``ik`` (original
    ids, (P, k)), each weighted by whether its distance ``dk`` is finite,
    in the cloud's dtype: the JAX package's gather path."""
    pb = gb.points.shape[0]
    inv_b = torch.empty(pb, dtype=torch.long, device=ik.device)
    inv_b[gb.perm.long()] = torch.arange(pb, device=ik.device)
    neigh = gb.points[inv_b[ik.long().clamp(0, pb - 1)]]  # (P, k, 3)
    w = torch.isfinite(dk).to(gb.points.dtype)[:, :, None]
    diffs = (neigh - ga.points[:, None, :]) * w
    dx, dy, dz = diffs.unbind(dim=2)
    sq = torch.stack([dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz],
                     dim=2)
    return torch.cat([w[:, :, 0].sum(dim=1, keepdim=True), diffs.sum(dim=1),
                      sq.sum(dim=1)], dim=1)


def knn_pruned_sorted(
    ga: ChunkGrid,
    gb: ChunkGrid,
    n_a: int,
    k: int,
    exclude_self: bool = False,
    cap: int = 32,
    fallback_tiles: int = 128,
    refine_impl: str = "auto",
    with_moments: bool = False,
    flags: typing.Optional[KnnFlags] = None,
    *,
    p1: typing.Optional[int] = None,
    prologue: typing.Optional[str] = None,
    sched: typing.Optional[str] = None,
) -> typing.Tuple[torch.Tensor, ...]:
    """k-NN in Morton-sorted query order; ORIGINAL neighbour indices.

    ``n_a`` is the query cloud's valid count (sorted row s is valid iff
    s < n_a). Returns ``(dist_sq (P, k), idx (P, k) int32, overflow 0-d
    bool tensor)``, ascending by distance; with ``with_moments`` a fourth
    output, (P, MOM_CH) sums [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz,
    syz] of the offsets from each query to its k neighbours (K4's, or with
    ``exclude_self`` ``gather_moments``).

    ``flags`` (``knn_flags_from_env()`` read at this call when None) picks
    the schedule; ``p1``, ``prologue`` and ``sched``, when given, replace
    their fields. Kernel route (``refine_impl`` "auto", "pallas" or
    "pallas_interpret"), counted schedule (cap > 8, nta % 8 == 0): a probe
    of the ``p1`` lowest-lb chunks of every tile, a certificate count from
    the k-th distance, an extension of each tile to min(count, cap) chunks
    seeded from the probe (gated per tile), then tier A (the top
    ``fallback_tiles`` tiles by count, widened to cap2a = min(max(2 cap,
    128), ncb)) and tier B (the worst of those, widened to cap2b =
    min(max(8 cap, 512, ncb // 4), ncb)), both seeded, gated and read in
    place through global tile ids. Otherwise (the fixed schedule, and the
    plain route "xla") stage 1 is K2c's ``cap`` candidates and one K3b
    refine of all of them. The moments pass walks the same prefixes:
    min(count, cap) chunks of every tile, then each tier's extension (from
    zero over the tier's prefix in select mode), with the count taken from
    the final k-th distances. The prologue ("xla" or "select") as in the
    module docstring.
    """
    if refine_impl not in REFINE_IMPLS:
        raise ValueError(f"unknown refine_impl {refine_impl!r}; one of "
                         f"{REFINE_IMPLS}")
    flags = resolve_knn_flags(flags, p1=p1, prologue=prologue, sched=sched)
    n_a = int(n_a)
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    cap = min(cap, ncb)
    sched = "counted" if flags.sched == "counted" else "fixed"
    counted = (refine_impl in KERNEL_ROUTE and sched == "counted" and cap > 8
               and nta % 8 == 0)
    prologue = "select" if flags.prologue == "select" else "xla"
    pro = run_prologue(ga, gb, n_a, cap,
                       counted and uses_select(prologue, cap, ga.points.dtype),
                       fixed=not counted)
    valid_t, order = pro.valid_t, pro.order

    def refine(cand, **kw):
        return refine_knn(ga.points, gb.points, gb.perm, cand.contiguous(), k,
                          exclude_self=exclude_self, **kw)

    def kth_ub(dk, tvalid):
        return cert_ub(dk[:, :, k - 1], tvalid)

    if counted:
        p1 = max(1, min(flags.p1, cap - 1))
        d1, i1 = refine(order[:, :p1])
        counts1 = pro.counts(kth_ub(d1, valid_t))
        ncand2 = torch.clamp(counts1 - p1, 0, cap - p1).to(torch.int32)
        dk, ik = refine(order[:, p1:cap], ncand=ncand2, init=(d1, i1))
        refined1 = p1 + ncand2  # each tile's refined prefix of ``order``
    else:
        dk, ik = refine_knn_straight(ga.points, gb.points, gb.perm, order, k,
                                     exclude_self=exclude_self,
                                     boxes=(gb.bbox_lo, gb.bbox_hi))

    # ---- stage-1 certificate on the k-th distance
    ub_eff = kth_ub(dk, valid_t)
    counts = pro.counts(ub_eff)
    ft = min(fallback_tiles, nta)
    cap2a = min(max(2 * cap, 128), ncb)
    cap2b = min(max(8 * cap, 512, ncb // 4), ncb)
    overflow = (counts > cap).sum() > ft

    def tier(tiles, cand, ncand, tlb):
        """Re-refine ``tiles`` (global ids) over ``cand``, gated per tile by
        ``ncand`` and seeded with their current k-buffers, in place of
        those rows; returns their recounts against ``tlb``."""
        nonlocal dk, ik
        fd, fi = refine(cand, tiles=tiles.to(torch.int32),
                        ncand=ncand.to(torch.int32),
                        init=(dk[tiles].contiguous(), ik[tiles].contiguous()))
        dk = dk.index_copy(0, tiles, fd)
        ik = ik.index_copy(0, tiles, fi)
        return count_under(tlb, kth_ub(fd, valid_t[tiles]))

    tiers = []  # (tiles, lb rows, order rows, lo, hi) of each tier that ran
    if ft > 0 and cap2a > cap:
        otiles = stable_top(counts, ft)
        olb, oorder = tier_table(pro, gb, otiles)
        oc = counts[otiles]
        if pro.select:
            # The true-lb prefix as wide as the tile's true-lb count at the
            # stage-1 threshold, less the chunks stage 1 refined.
            ncand_a = torch.where(
                oc > cap, torch.clamp(count_under(olb, ub_eff[otiles]),
                                      max=cap2a), 0)
            seen = _mark(torch.zeros(olb.shape, dtype=torch.bool,
                                     device=olb.device),
                         order[otiles], refined1[otiles])
            counts2a = tier(otiles, *_unseen(oorder[:, :cap2a], ncand_a, seen),
                            olb)
        else:
            ncand_a = torch.where(oc > cap, torch.clamp(oc, max=cap2a) - cap,
                                  0)
            counts2a = tier(otiles, oorder[:, cap:cap2a], ncand_a, olb)
        tiers.append((otiles, olb, oorder, cap, cap2a))
        ft2 = min(max(ft // 8, 16), ft)
        if cap2b > cap2a:
            need_b = torch.where(counts2a > cap2a, counts2a, 0)
            overflow = overflow | ((need_b > 0).sum() > ft2)
            bsel = stable_top(need_b, ft2)
            nb = need_b[bsel]
            if pro.select:
                seen_b = _mark(seen[bsel], oorder[bsel, :cap2a],
                               ncand_a[bsel])
                cand_b, ncand_b = _unseen(
                    oorder[bsel, :cap2b],
                    torch.where(nb > 0, torch.clamp(nb, max=cap2b), 0),
                    seen_b)
            else:
                cand_b = oorder[bsel, cap2a:cap2b]
                ncand_b = torch.where(nb > 0,
                                      torch.clamp(nb, max=cap2b) - cap2a, 0)
            counts2b = tier(otiles[bsel], cand_b, ncand_b, olb[bsel])
            tiers.append((otiles[bsel], olb[bsel], oorder[bsel], cap2a,
                          cap2b))
            overflow = overflow | (counts2b > cap2b).any()
        else:
            overflow = overflow | (counts2a > cap2a).any()

    p = nta * CHUNK
    if not with_moments:
        return dk.reshape(p, k), ik.reshape(p, k), overflow
    if exclude_self:
        dk, ik = dk.reshape(p, k), ik.reshape(p, k)
        return dk, ik, overflow, gather_moments(ga, gb, dk, ik)

    # ---- moment sums of the exact k-NN sets. Members are the pairs
    # lexicographically <= the k-buffer's last slot, which is the k-set
    # the merge kept. Gate: the final certificate count covers every
    # member's chunk (member d <= r_k <= ub_eff, so its chunk's lb
    # qualifies), and the lb-ascending prefix of that width holds them all.
    rk = dk[:, :, k - 1].contiguous()
    rid = ik[:, :, k - 1].contiguous()
    ubf_eff = kth_ub(dk, valid_t)
    countsf = pro.counts(ubf_eff)
    boxes = (gb.bbox_lo, gb.bbox_hi)  # K4 skips slots by chunk box
    mom = knn_moments(ga.points, gb.points, gb.perm,
                      order[:, :cap].contiguous(),
                      torch.clamp(countsf, max=cap).to(torch.int32), rk, rid,
                      boxes=boxes)
    for tiles, tlb, torder, lo, hi in tiers:
        cf = countsf[tiles]
        t32 = tiles.to(torch.int32)
        rk_t, rid_t = rk[tiles].contiguous(), rid[tiles].contiguous()
        if pro.select:
            # From zero over the true-lb prefix, for the tiles stage 1 did
            # not cover; the others keep their stage-1 sums.
            take = cf > cap
            ncm = torch.where(take, torch.clamp(count_under(
                tlb, ubf_eff[tiles]), max=hi), 0)
            part = knn_moments(ga.points, gb.points, gb.perm,
                               torder[:, :hi].contiguous(),
                               ncm.to(torch.int32), rk_t, rid_t, tiles=t32,
                               boxes=boxes)
            part = torch.where(take[:, None, None], part, mom[tiles])
        else:
            # Extend the compacted tiles' sums past the prefix already
            # summed.
            ncm = torch.where(cf > lo, torch.clamp(cf, max=hi) - lo, 0)
            part = knn_moments(ga.points, gb.points, gb.perm,
                               torder[:, lo:hi].contiguous(),
                               ncm.to(torch.int32), rk_t, rid_t, tiles=t32,
                               init=mom[tiles].contiguous(), boxes=boxes)
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
    *,
    prologue: typing.Optional[str] = None,
    sched: typing.Optional[str] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Exact pruned k-NN in ORIGINAL order with automatic escalation.

    Returns ``(idx int32 (Pa, k), dist_sq (Pa, k))`` ascending by distance.
    The schedule flags are ``knn_flags_from_env()``, read at this call,
    with ``prologue`` and ``sched`` in place of theirs when given.
    """
    flags = resolve_knn_flags(prologue=prologue, sched=sched)
    ga = build_grid(a_points, int(n_a))
    gb = ga if exclude_self or a_points is b_points else build_grid(
        b_points, int(n_b))

    def run(cap, fallback):
        dk, ik, overflow = knn_pruned_sorted(
            ga, gb, n_a, k, exclude_self=exclude_self, cap=cap,
            fallback_tiles=fallback, flags=flags)
        with span("pcc.readback"):
            overflow = bool(overflow)
        return (dk, ik), overflow

    # The JAX package's key: both schedules overflow on the same rungs.
    key = (a_points.shape[0], b_points.shape[0], k, exclude_self)
    (dk, ik), _ = climb(run, (cap, fallback_tiles),
                        b_points.shape[0] // CHUNK, a_points.shape[0] // CHUNK,
                        _ESCALATION_MEMO, key)
    return unsort_rows(ga, ik), unsort_rows(ga, dk)
