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
never silently lost. Every refine goes through ``refine.refine_nn`` (K1),
except the fixed schedule's stage 1 (K1b, below).

The knobs below are resolved once a call into one ``NnSchedule``, the
1-NN counterpart of ``knn_pruned.KnnFlags``: each public entry point, here
and in ``ops/fused.py``, passes its keywords to ``resolve_nn_schedule``,
which reads the environment for the rest; the layers below take that
value. Every ladder is ``utils.cache.climb``.

Two prologues produce the stage-1 candidates and counts, chosen per call
(``prologue``; ``PCC_NN_PROLOGUE``, where "select" selects and anything
else means the default):

  * "xla", the default (``tile_bounds``): the whole (nta, ncb) lb matrix,
    a stable sort of each row and counts over it. The order is total:
    equal lbs keep ascending chunk index — what XLA's ``top_k`` gives, and
    what the tiers' skip-the-refined-prefix step relies on (``torch.topk``
    promises no order among ties). Tier tiles are picked by a stable
    descending sort the same way.
  * "select" (float32 clouds, cap > 8): K2a (``select.select_bbox``) gives
    each tile's ``cap`` candidates and K2b (``select.count_bbox``) every
    stage-1 count, both in the kernels' rounded-key space and without the
    matrix. The tiers work in true-lb space only: the bounds of their
    compacted tiles, sorted, and a refine of the FULL prefix seeded with
    the current rows (stage 1's rounded order shares no usable prefix with
    it). Results equal the default's bit for bit; tier choice and
    ``overflow`` follow the JAX package's select mode.

Two stage-1 schedules, chosen per call (``sched``; ``PCC_NN_SCHED``, where
"counted", the default, counts and any other value means "fixed", as in the
JAX package):

  * "counted" (cap > 8): the probe, the certificate count and the gated,
    seeded extension below;
  * "fixed" (and any cap <= 8): the lb matrix, K2c's ``cap`` candidates
    (``refine.select_candidates``) and one ungated, unseeded K1b launch
    (``refine.refine_nn_straight``) over every tile. K2c repeats column 0
    on the all-+inf rows of tiles without a valid query; their results are
    discarded. The tiers, the counts and ``overflow`` are the counted
    schedule's, and so are the results.

Two more schedules, the JAX package's opt-in ones, give the same results
on valid rows:

  * ``refine_impl="adaptive"`` on clouds whose distances the expanded-norm
    form computes exactly (``mxu_ok``, from ``Cloud.mxu_exact``):
    ``nn_pruned_adaptive_sorted``, three K7 passes (``refine_adaptive``)
    over the bound matrix. Other clouds keep the default schedule, as in
    the JAX package. ``refine_impl="expanded"`` (with ``mxu_ok``) keeps the
    default schedule and runs every K1 call in its expanded-norm mode
    (``PCC_REFINE_IMPL`` "adaptive", ``PCC_NN_EXPANDED`` "1";
    ``resolve_refine_impl``).
  * ``nn_pruned_sorted_payload``: stage 1 through K6, which also returns
    the winner's payload row, and one tier refined from scratch through K1
    (the fused evaluation's ``PCC_PAYLOAD_KERNEL=1``).
  * ``nn_pruned_bucketed_sorted`` (cross searches only; no caller in either
    package but tests): a probe, one seeded pass of the tiles that need
    more, then its own two tiers, every pass through K1.
"""
from __future__ import annotations

import os
import typing

import torch

from .grid import CHUNK, ChunkGrid, bbox_lower_bounds, build_grid
from .refine import (
    PAYLOAD_F, refine_nn, refine_nn_payload, refine_nn_straight,
    select_candidates)
from .refine_adaptive import adaptive_refine, pack_candidates, pack_queries
from .select import count_bbox, select_bbox
from .._layout_args import check_interpret, check_pack
from ..utils.cache import climb
from ..utils.profiling import span, spanned

PROLOGUES = ("xla", "select")
NN_PROLOGUE_ENV = "PCC_NN_PROLOGUE"
KNN_PROLOGUE_ENV = "PCC_KNN_PROLOGUE"
REFINE_IMPLS = ("default", "adaptive", "expanded")
# The JAX package's names for its routes, as the schedules they run here:
# its kernel and plain routes are the default schedule (K1 on the card,
# never the plain refine), its interpret-mode adaptive route the adaptive
# schedule. "auto", its default, reads the environment as None does.
JAX_REFINE_IMPLS = {"pallas": "default", "pallas_interpret": "default",
                    "xla": "default", "adaptive_interpret": "adaptive"}
REFINE_IMPL_ENV = "PCC_REFINE_IMPL"
NN_EXPANDED_ENV = "PCC_NN_EXPANDED"
SCHEDS = ("counted", "fixed")
NN_SCHED_ENV = "PCC_NN_SCHED"
KNN_SCHED_ENV = "PCC_KNN_SCHED"
NN_P1_ENV = "PCC_NN_P1"
KNN_P1_ENV = "PCC_KNN_P1"
PAYLOAD_ENV = "PCC_PAYLOAD_KERNEL"
NN_CAP_ENV, NN_FT_ENV = "PCC_NN_CAP", "PCC_NN_FT"


def resolve_sched(sched: typing.Optional[str], env: str) -> str:
    """The stage-1 schedule a call runs: ``sched`` when given, else read
    from the environment variable ``env`` at this call ("counted" when it
    is unset or "counted", "fixed" for any other value, as in the JAX
    package)."""
    if sched is None:
        return ("counted" if os.environ.get(env, "counted") == "counted"
                else "fixed")
    if sched not in SCHEDS:
        raise ValueError(f"unknown schedule {sched!r}; one of {SCHEDS}")
    return sched


def resolve_nn_sched(sched: typing.Optional[str] = None) -> str:
    """``resolve_sched`` of the 1-NN searches (``PCC_NN_SCHED``)."""
    return resolve_sched(sched, NN_SCHED_ENV)


def resolve_knn_sched(sched: typing.Optional[str] = None) -> str:
    """``resolve_sched`` of the k-NN searches (``PCC_KNN_SCHED``)."""
    return resolve_sched(sched, KNN_SCHED_ENV)


def resolve_p1(p1: typing.Optional[int], env: str) -> int:
    """The counted schedule's probe width: ``p1`` when given, else the
    environment variable ``env`` read at this call (8 when unset)."""
    return int(os.environ.get(env, "8")) if p1 is None else int(p1)


def resolve_refine_impl(refine_impl: typing.Optional[str] = None) -> str:
    """The 1-NN refine schedule a call asks for, one of ``REFINE_IMPLS``:
    ``refine_impl`` when it names one, a JAX package name mapped through
    ``JAX_REFINE_IMPLS``, and for None or "auto" read from the environment
    at this call: "adaptive" when ``PCC_REFINE_IMPL`` is "adaptive", else
    "expanded" when ``PCC_NN_EXPANDED`` is "1", else "default". Either
    only takes effect on clouds that pass ``Cloud.mxu_exact``
    (``nn_pruned_sorted``'s mxu_ok)."""
    if refine_impl is None or refine_impl == "auto":
        if os.environ.get(REFINE_IMPL_ENV) == "adaptive":
            return "adaptive"
        return "expanded" if os.environ.get(NN_EXPANDED_ENV) == "1" \
            else "default"
    refine_impl = JAX_REFINE_IMPLS.get(refine_impl, refine_impl)
    if refine_impl not in REFINE_IMPLS:
        names = REFINE_IMPLS + ("auto",) + tuple(JAX_REFINE_IMPLS)
        raise ValueError(f"unknown refine_impl {refine_impl!r}; one of "
                         f"{names}")
    return refine_impl


def resolve_prologue(prologue: typing.Optional[str], env: str) -> str:
    """The prologue a call runs: ``prologue`` when given, else read from
    the environment variable ``env`` at this call ("select" selects, any
    other value or none means "xla", as in the JAX package)."""
    if prologue is None:
        return "select" if os.environ.get(env, "xla") == "select" else "xla"
    if prologue not in PROLOGUES:
        raise ValueError(f"unknown prologue {prologue!r}; one of {PROLOGUES}")
    return prologue


def resolve_payload(payload: typing.Optional[bool] = None) -> bool:
    """Whether the cross sweeps may take the payload schedule (K6):
    ``payload`` when given, else ``PCC_PAYLOAD_KERNEL == "1"`` read at this
    call."""
    if payload is None:
        return os.environ.get(PAYLOAD_ENV) == "1"
    return bool(payload)


def nn_base_rung(cap: typing.Optional[int] = None,
                 fallback: typing.Optional[int] = None):
    """The pruned sweeps' base rung: each of ``cap`` and ``fallback`` when
    given, else ``PCC_NN_CAP`` / ``PCC_NN_FT`` read at this call (32 and
    256 when unset), as the JAX package's ``fused_evaluate`` reads them."""
    return (int(os.environ.get(NN_CAP_ENV, "32")) if cap is None else cap,
            int(os.environ.get(NN_FT_ENV, "256")) if fallback is None
            else fallback)


class NnSchedule(typing.NamedTuple):
    """The 1-NN searches' schedule, resolved once a call. ``cap`` and
    ``fallback`` are the ladder's base rung; a ladder runs each rung as
    ``_replace(cap=, fallback=)``."""
    sched: str  # stage 1, "counted" or "fixed"
    p1: int  # the counted schedule's probe width
    prologue: str  # "xla" or "select"
    refine_impl: str  # one of REFINE_IMPLS
    payload: bool  # the cross sweeps through K6 where the pair allows
    cap: int  # stage-1 chunks a tile
    fallback: int  # the tiers' tile budget


def resolve_nn_schedule(*, sched: typing.Optional[str] = None,
                        p1: typing.Optional[int] = None,
                        prologue: typing.Optional[str] = None,
                        refine_impl: typing.Optional[str] = None,
                        payload: typing.Optional[bool] = None,
                        cap: typing.Optional[int] = None,
                        fallback: typing.Optional[int] = None) -> NnSchedule:
    """Each value given, the rest read from the environment now, by the
    rules (defaults, JAX names, errors) of ``resolve_nn_sched``,
    ``resolve_p1`` (``PCC_NN_P1``), ``resolve_prologue``
    (``PCC_NN_PROLOGUE``), ``resolve_refine_impl``, ``resolve_payload`` and
    ``nn_base_rung``."""
    return NnSchedule(
        resolve_nn_sched(sched), resolve_p1(p1, NN_P1_ENV),
        resolve_prologue(prologue, NN_PROLOGUE_ENV),
        resolve_refine_impl(refine_impl), resolve_payload(payload),
        *nn_base_rung(cap, fallback))


def stable_top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, ties to the lower
    index (XLA ``top_k`` order), as int64."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def lb_order(lb: torch.Tensor) -> torch.Tensor:
    """Each row's columns in ascending-lb order (stable, int32)."""
    return torch.sort(lb, dim=1, stable=True).indices.to(torch.int32)


def tile_boxes(ga: ChunkGrid, n_a: int):
    """(valid_t, a_lo, a_hi): the (nta, 256) validity mask of the query
    rows and each tile's (nta, 3) bbox over its VALID rows (an empty tile
    spans +max to -max)."""
    dtype = ga.points.dtype
    big = torch.finfo(dtype).max
    nta = ga.points.shape[0] // CHUNK
    a_tiles = ga.points.reshape(nta, CHUNK, 3)
    valid_t = (torch.arange(nta * CHUNK, device=ga.points.device)
               < n_a).reshape(nta, CHUNK)
    a_lo = torch.where(valid_t[:, :, None], a_tiles, big).amin(dim=1)
    a_hi = torch.where(valid_t[:, :, None], a_tiles, -big).amax(dim=1)
    return valid_t, a_lo, a_hi


def tile_bounds(ga: ChunkGrid, gb: ChunkGrid, n_a: int):
    """(valid_t, lb, order): the (nta, 256) validity mask of the query rows,
    the (nta, ncb) bbox lower bounds over VALID query rows, and each row's
    chunks in ascending-lb order (stable, int32). The default prologue."""
    valid_t, a_lo, a_hi = tile_boxes(ga, n_a)
    lb = bbox_lower_bounds(a_lo, a_hi, gb.bbox_lo, gb.bbox_hi)
    return valid_t, lb, lb_order(lb)


def cert_ub(d: torch.Tensor, valid_t: torch.Tensor) -> torch.Tensor:
    """Each tile's padded certificate threshold: the largest ``d`` over its
    valid rows, widened by 8 eps relative and absolute."""
    eps = torch.finfo(d.dtype).eps
    ub = torch.where(valid_t, d, -torch.inf).amax(dim=1)
    return ub * (1 + 8 * eps) + 8 * eps


def count_under(lb: torch.Tensor, ub_eff: torch.Tensor) -> torch.Tensor:
    """(rows,) int32 counts of the entries of each lb row <= its ub_eff."""
    return (lb <= ub_eff[:, None]).sum(dim=1, dtype=torch.int32)


class Prologue(typing.NamedTuple):
    """Stage-1 inputs of a pruned search, from either prologue."""
    valid_t: torch.Tensor  # (nta, 256) valid query rows
    order: torch.Tensor  # (nta, >= cap) int32 candidates, lowest lb first
    counts: typing.Callable[[torch.Tensor], torch.Tensor]  # ub_eff -> (nta,)
    lb: typing.Optional[torch.Tensor]  # (nta, ncb) true lb; None in select
    boxes: typing.Optional[tuple]  # select: the (nta, 3) a_lo and a_hi

    @property
    def select(self) -> bool:
        return self.lb is None


def run_prologue(ga: ChunkGrid, gb: ChunkGrid, n_a: int, cap: int,
                 select: bool, fixed: bool = False) -> Prologue:
    """The default prologue (``tile_bounds``, counts over the lb matrix);
    with ``select``, K2a's ``cap`` candidates and K2b's counts; with
    ``fixed`` (the fixed schedule), the lb matrix, its counts and K2c's
    ``cap`` candidates in place of the full sort."""
    if fixed:
        valid_t, a_lo, a_hi = tile_boxes(ga, n_a)
        lb = bbox_lower_bounds(a_lo, a_hi, gb.bbox_lo, gb.bbox_hi)
        return Prologue(valid_t, select_candidates(lb, cap),
                        lambda ub_eff: count_under(lb, ub_eff), lb, None)
    if not select:
        valid_t, lb, order = tile_bounds(ga, gb, n_a)
        return Prologue(valid_t, order,
                        lambda ub_eff: count_under(lb, ub_eff), lb, None)
    valid_t, a_lo, a_hi = tile_boxes(ga, n_a)
    order, _ = select_bbox(a_lo, a_hi, gb.bbox_lo, gb.bbox_hi, cap)
    return Prologue(valid_t, order, lambda ub_eff: count_bbox(
        a_lo, a_hi, gb.bbox_lo, gb.bbox_hi, ub_eff), None, (a_lo, a_hi))


def uses_select(prologue: str, cap: int, dtype: torch.dtype,
                sched: str = "counted") -> bool:
    """Whether a search runs the select prologue: asked for, on the counted
    schedule (cap > 8) of a float32 cloud, as in the JAX package."""
    if prologue not in PROLOGUES:
        raise ValueError(f"unknown prologue {prologue!r}; one of {PROLOGUES}")
    return (prologue == "select" and sched == "counted" and cap > 8
            and dtype == torch.float32)


def tier_table(pro: Prologue, gb: ChunkGrid, tiles: torch.Tensor):
    """(lb rows, lb-ascending order rows) of the compacted ``tiles``: rows
    of the matrix and of its full sort by default; the matrix rows sorted
    when stage 1 kept only ``cap`` candidates (the fixed schedule); their
    true bounds recomputed and sorted in select mode.

    On the fixed schedule the first ``cap`` columns of a sorted row equal
    K2c's picks on every tile with a valid query (its bounds are finite,
    and K2c picks a finite row's stable ascending prefix), so the tiers may
    skip stage 1's refined prefix there too. Tiles without a valid query
    count 0 and refine no chunk."""
    if pro.select:
        a_lo, a_hi = pro.boxes
        olb = bbox_lower_bounds(a_lo[tiles], a_hi[tiles], gb.bbox_lo,
                                gb.bbox_hi)
    else:
        olb = pro.lb[tiles]
        if pro.order.shape[1] == olb.shape[1]:
            return olb, pro.order[tiles]
    return olb, lb_order(olb)


def nn_pruned_sorted(
    ga: ChunkGrid,
    gb: ChunkGrid,
    n_a: int,
    exclude_self: bool = False,
    cap: int = 32,
    fallback_tiles: int = 128,
    refine_impl: str = "auto",
    mxu_ok: bool = False,
    qt8: typing.Optional[torch.Tensor] = None,
    *,
    p1: typing.Optional[int] = None,
    prologue: str = "xla",
    sched: str = "counted",
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-NN in Morton-sorted query order.

    ``n_a`` is the query cloud's valid count: sorted row s is valid iff
    s < n_a. Returns ``(dist_sq (Pa,), idx_into_ORIGINAL_b (Pa,) int32,
    overflow 0-d bool tensor)``. Sentinel query rows return meaningless
    (finite) distances — callers mask by row < n_a.

    Schedule (module docstring; the knobs not given, ``p1`` None and
    ``refine_impl`` "auto", are read at this call): on the counted one a
    probe of the ``p1`` lowest-lb chunks of every tile (8 by default), a
    certificate count from its ub, an in-place extension of each tile to
    min(count, cap) chunks seeded from the probe (gated per tile), then
    tier A (the top ``fallback_tiles`` tiles by count, widened to cap2a)
    and tier B (the worst of those, widened to cap2b), both seeded and
    gated. ``mxu_ok`` asserts that both clouds pass ``Cloud.mxu_exact``;
    only then does ``refine_impl`` "adaptive" run
    ``nn_pruned_adaptive_sorted`` (at cap max(64, cap) and ft3 max(64,
    fallback_tiles // 4), as in the JAX package) and "expanded" K1's
    expanded-norm mode (in the tiers only on the fixed schedule: K1b has
    the difference form alone), bit-identical on valid rows. ``qt8`` is
    the JAX package's query pack, checked and unused (``_layout_args``).
    """
    check_pack("qt8", qt8)
    return _nn_pruned_sorted(ga, gb, n_a, exclude_self, resolve_nn_schedule(
        sched=sched, p1=p1, prologue=prologue, refine_impl=refine_impl,
        payload=False, cap=cap, fallback=fallback_tiles), mxu_ok)


@spanned("pcc.sweep")
def _nn_pruned_sorted(ga: ChunkGrid, gb: ChunkGrid, n_a: int,
                      exclude_self: bool, nn: NnSchedule, mxu_ok: bool):
    """``nn_pruned_sorted`` on the resolved schedule ``nn``."""
    if nn.refine_impl == "adaptive" and mxu_ok:
        return nn_pruned_adaptive_sorted(
            ga, gb, n_a, exclude_self=exclude_self, cap=max(64, nn.cap),
            ft3=max(64, nn.fallback // 4))
    expanded = nn.refine_impl == "expanded" and mxu_ok
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    cap = min(nn.cap, ncb)
    counted = nn.sched == "counted" and cap > 8
    pro = run_prologue(ga, gb, n_a, cap,
                       uses_select(nn.prologue, cap, ga.points.dtype,
                                   nn.sched),
                       fixed=not counted)
    valid_t, order = pro.valid_t, pro.order

    def refine(cand, **kw):
        return refine_nn(ga.points, gb.points, gb.perm, cand.contiguous(),
                         exclude_self=exclude_self, expanded=expanded, **kw)

    if counted:
        p1 = max(1, min(nn.p1, cap - 1))
        d1, i1 = refine(order[:, :p1])
        counts1 = pro.counts(cert_ub(d1, valid_t))
        ncand2 = torch.clamp(counts1 - p1, 0, cap - p1).to(torch.int32)
        dmin, gidx = refine(order[:, p1:cap], ncand=ncand2, init=(d1, i1))
    else:
        # One launch over every tile: the JAX package runs its straight
        # kernel on the tiles that do not fill an 8-tile group only.
        dmin, gidx = refine_nn_straight(ga.points, gb.points, gb.perm, order,
                                        exclude_self=exclude_self)

    # ---- stage-1 exactness certificate
    ub_eff = cert_ub(dmin, valid_t)
    counts = pro.counts(ub_eff)
    ft = min(nn.fallback, nta)
    cap2a = min(max(4 * cap, 128), ncb)
    cap2b = min(max(16 * cap, 512, ncb // 4), ncb)
    overflow = (counts > cap).sum() > ft

    def tier(tiles, cand, ncand, tlb):
        """Re-refine ``tiles`` (global ids) over ``cand``, gated per tile by
        ``ncand`` and seeded with their current rows, in place of those
        rows; returns their recounts against ``tlb``."""
        nonlocal dmin, gidx
        fd, fi = refine(cand, tiles=tiles.to(torch.int32),
                        ncand=ncand.to(torch.int32),
                        init=(dmin[tiles].contiguous(),
                              gidx[tiles].contiguous()))
        dmin = dmin.index_copy(0, tiles, fd)
        gidx = gidx.index_copy(0, tiles, fi)
        return count_under(tlb, cert_ub(fd, valid_t[tiles]))

    if ft > 0 and cap2a > cap:
        # Tier A: every over-cap tile lands here when n_over <= ft.
        otiles = stable_top(counts, ft)
        olb, oorder = tier_table(pro, gb, otiles)
        oc = counts[otiles]
        if pro.select:
            # The full true-lb prefix, as wide as the tile's true-lb count
            # at the stage-1 threshold (its recount can only shrink).
            ncand_a = torch.where(
                oc > cap, torch.clamp(count_under(olb, ub_eff[otiles]),
                                      max=cap2a), 0)
            counts2a = tier(otiles, oorder[:, :cap2a], ncand_a, olb)
        else:
            # Only the chunks beyond the refined prefix of width cap.
            ncand_a = torch.where(oc > cap, torch.clamp(oc, max=cap2a) - cap,
                                  0)
            counts2a = tier(otiles, oorder[:, cap:cap2a], ncand_a, olb)
        ft2 = min(max(ft // 8, 16), ft)
        if cap2b > cap2a:
            # Tier B: the few tiles whose qualifying set exceeds tier A's
            # width (counts against tier-A results are sound: ub only
            # shrinks with more refinement).
            need_b = torch.where(counts2a > cap2a, counts2a, 0)
            overflow = overflow | ((need_b > 0).sum() > ft2)
            bsel = stable_top(need_b, ft2)
            nb = need_b[bsel]
            lo = 0 if pro.select else cap2a
            ncand_b = torch.where(nb > 0, torch.clamp(nb, max=cap2b) - lo, 0)
            counts2b = tier(otiles[bsel], oorder[bsel, lo:cap2b], ncand_b,
                            olb[bsel])
            overflow = overflow | (counts2b > cap2b).any()
        else:
            overflow = overflow | (counts2a > cap2a).any()

    return dmin.reshape(nta * CHUNK), gidx.reshape(nta * CHUNK), overflow


def nn_pruned_adaptive_sorted(
    ga: ChunkGrid,
    gb: ChunkGrid,
    n_a: int,
    exclude_self: bool = False,
    cap: int = 64,
    ft3: int = 64,
    p1: int = 8,
    interpret: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adaptive 1-NN schedule (the JAX package's
    ``nn_pruned_adaptive_sorted``), every refine through K7.

    Same contract as ``nn_pruned_sorted``. Only for float32 clouds that
    pass ``Cloud.mxu_exact`` (the caller's gate): K7's expanded-norm
    distances are exact there.

      P1  a probe of the ``p1`` lowest-lb chunks of every tile;
      P2  each tile extended, seeded and gated, to min(count1, cap) chunks
          of its lb order, count1 being the certificate count of P1's ub;
      P3  the ``ft3`` tiles with the largest count2 > cap (count2 from P2's
          ub) refined over their lb order up to count2 slots.

    ``overflow`` is set when more than ``ft3`` tiles need P3; a tile that
    P3 refined is exact by construction.

    The JAX package's P3 walks each tail tile from scratch over
    ``order[:count2]``. Here P3 walks only ``order[cap:count2]``, seeded
    with P2's rows, and the rows are the same bit for bit: ub only shrinks
    from P1 to P2, so count2 > cap implies count1 >= count2 > cap, and P1
    and P2 together walked all of ``order[:cap]`` for every tail tile; the
    lexicographic (d, id) minimum is associative and idempotent, and each
    candidate's d is computed the same way in every pass. A tile that P3
    does not extend (ncand 0) keeps its seed unchanged. ``interpret`` is
    the JAX package's interpret-mode switch, checked and unused.
    """
    check_interpret(interpret)
    if ga.points.dtype != torch.float32:
        raise ValueError("adaptive refinement is float32-only")
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    cap = min(cap, ncb)
    p1 = min(p1, cap)
    valid_t, lb, order = tile_bounds(ga, gb, n_a)
    qhat = pack_queries(ga.points)
    bhat = pack_candidates(gb.points, gb.perm)
    tids = torch.arange(nta, dtype=torch.int32, device=ga.points.device)

    def refine(cand, ncand, tiles, init=None):
        return adaptive_refine(qhat, bhat, cand.contiguous(),
                               ncand.to(torch.int32), tiles, init=init,
                               exclude_self=exclude_self)

    d1, i1 = refine(order[:, :p1], torch.full_like(tids, p1), tids)
    count1 = count_under(lb, cert_ub(d1, valid_t))
    if cap > p1:
        ncand2 = torch.clamp(torch.clamp(count1, max=cap) - p1, 0, cap - p1)
        d2, i2 = refine(order[:, p1:cap], ncand2, tids, init=(d1, i1))
    else:
        d2, i2 = d1, i1
    count2 = count_under(lb, cert_ub(d2, valid_t))

    ft = min(ft3, nta)
    is_tail = count2 > cap
    overflow = is_tail.sum() > ft
    if ft > 0 and cap < ncb:
        otiles = stable_top(torch.where(is_tail, count2, 0), ft)
        ncand3 = torch.where(is_tail[otiles], count2[otiles] - cap, 0)
        # order rows are each tile's full stable lb order (jnp.argsort's).
        d3, i3 = refine(order[otiles, cap:], ncand3, otiles.to(torch.int32),
                        init=(d2[otiles], i2[otiles]))
        d2 = d2.index_copy(0, otiles, d3)
        i2 = i2.index_copy(0, otiles, i3)
    return d2.reshape(nta * CHUNK), i2.reshape(nta * CHUNK), overflow


@spanned("pcc.sweep")
def nn_pruned_sorted_payload(
    ga: ChunkGrid,
    gb: ChunkGrid,
    pay_sorted: torch.Tensor,
    pay_orig: torch.Tensor,
    n_a: int,
    exclude_self: bool = False,
    cap: int = 32,
    fallback_tiles: int = 128,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-NN in Morton-sorted query order plus the winner's payload row (the
    JAX package's ``nn_pruned_sorted_payload``).

    ``pay_sorted`` (Pb, PAYLOAD_F) is the search cloud's payload in sorted
    order, ``pay_orig`` the same rows in original order. The JAX package
    takes the sorted payload transposed, (PAYLOAD_F, Pb), as
    ``payT_sorted``: that layout, or any other but (Pb, PAYLOAD_F), raises
    ValueError rather than be read as rows. Returns ``(dist_sq
    (Pa,), idx_into_ORIGINAL_b (Pa,) int32, payload (Pa, PAYLOAD_F),
    overflow)``. Schedule: stage 1 is K6 over the ``cap`` lowest-lb chunks
    of every tile, ungated and unseeded; then the certificate, and one tier
    of the top ``fallback_tiles`` tiles by count (over-cap or not) refined
    from scratch through K1 over cap2 = min(max(8 cap, 512), ncb) chunks,
    their payload rows patched by a gather of ``pay_orig`` at the id.
    """
    want = (gb.points.shape[0], PAYLOAD_F)
    if tuple(pay_sorted.shape) != want:
        raise ValueError(
            f"pay_sorted must be {want} (search rows, payload columns), got "
            f"{tuple(pay_sorted.shape)}; the JAX package's payT_sorted is "
            f"its transpose")
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    cap = min(cap, ncb)
    valid_t, lb, order = tile_bounds(ga, gb, n_a)
    dmin, gidx, pay = refine_nn_payload(
        ga.points, gb.points, gb.perm, pay_sorted,
        order[:, :cap].contiguous(), exclude_self=exclude_self)
    counts = count_under(lb, cert_ub(dmin, valid_t))
    ft = min(fallback_tiles, nta)
    cap2 = min(max(8 * cap, 512), ncb)
    overflow = (counts > cap).sum() > ft
    if ft > 0 and cap2 > cap:
        otiles = stable_top(counts, ft)
        fd, fi = refine_nn(ga.points, gb.points, gb.perm,
                           order[otiles, :cap2].contiguous(),
                           tiles=otiles.to(torch.int32),
                           exclude_self=exclude_self)
        counts2 = count_under(lb[otiles], cert_ub(fd, valid_t[otiles]))
        overflow = overflow | (counts2 > cap2).any()
        dmin = dmin.index_copy(0, otiles, fd)
        gidx = gidx.index_copy(0, otiles, fi)
        fpay = pay_orig[fi.long().clamp(0, pay_orig.shape[0] - 1)]
        pay = pay.reshape(nta, CHUNK, PAYLOAD_F).index_copy(
            0, otiles, fpay).reshape(nta * CHUNK, PAYLOAD_F)
    return (dmin.reshape(nta * CHUNK), gidx.reshape(nta * CHUNK), pay,
            overflow)


def nn_pruned_bucketed_sorted(
    ga: ChunkGrid,
    gb: ChunkGrid,
    n_a: int,
    p1: int = 8,
    b1_extra: int = 40,
    interpret: bool = False,
    mxu_ok: bool = False,
    qt8: typing.Optional[torch.Tensor] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certificate-bucketed cross 1-NN (the JAX package's
    ``nn_pruned_bucketed_sorted``): same contract as ``nn_pruned_sorted``
    without ``exclude_self``.

      P   a probe of the ``p1`` lowest-lb chunks of every tile;
      B1  the tiles whose count exceeds the probe (at most ftb = min(max(8,
          ceil8(5 nta / 8)), nta), the largest counts first; more set
          ``overflow``), extended over slots [p1, w1), w1 = min(p1 +
          b1_extra, ncb), seeded;
      A   the ``ft`` = min(256, nta) tiles whose count exceeds w1, over
          their cap2a = min(max(4 w1, 192), ncb) lowest-lb chunks, seeded;
      B   the ft2 = min(32, ft) of those still over cap2a, over cap2b =
          min(512, ncb) chunks, seeded.

    Every pass is K1 over global tile ids; tiles and candidates are chosen
    by stable order (``stable_top``, the stable lb sort). The JAX package
    refines every chosen tile over the pass's whole width; here each pass
    is gated to what a tile's count needs (none for a tile that does not).
    Whenever ``overflow`` is clear the rows are the same: every tile is
    then certified, its row the exact lexicographic (d, id) minimum, and
    the prefix its count covers holds every chunk that could beat it.
    ``mxu_ok`` is taken for the JAX package's signature; every pass runs
    K1's difference form. ``interpret`` and ``qt8`` are the JAX package's
    interpret-mode switch and query pack, checked and unused.
    """
    check_interpret(interpret)
    check_pack("qt8", qt8)
    nta = ga.points.shape[0] // CHUNK
    ncb = gb.n_chunks
    p1 = min(p1, ncb)
    w1 = min(p1 + b1_extra, ncb)
    valid_t, lb, order = tile_bounds(ga, gb, n_a)

    def counts_of(d, tiles=None):
        if tiles is None:
            return count_under(lb, cert_ub(d, valid_t))
        return count_under(lb[tiles], cert_ub(d, valid_t[tiles]))

    d1, i1 = refine_nn(ga.points, gb.points, gb.perm,
                       order[:, :p1].contiguous())
    counts1 = counts_of(d1)
    overflow = torch.zeros((), dtype=torch.bool, device=d1.device)

    def extend(tiles, lo, width, need):
        """Refine ``tiles`` over slots [lo, width) of their lb order, each
        gated to its count when ``need`` says it needs more, seeded."""
        nonlocal d1, i1
        live = torch.where(need[tiles],
                           torch.clamp(counts1[tiles], max=width) - lo, 0)
        t = tiles.to(torch.int32)
        fd, fi = refine_nn(ga.points, gb.points, gb.perm,
                           order[tiles, lo:width].contiguous(), tiles=t,
                           ncand=live.to(torch.int32),
                           init=(d1[tiles], i1[tiles]))
        d1, i1 = d1.index_copy(0, tiles, fd), i1.index_copy(0, tiles, fi)
        return fd

    if w1 > p1:
        ftb = min(max(8, (5 * nta // 8 + 7) // 8 * 8), nta)
        need1 = counts1 > p1
        overflow = overflow | (need1.sum() > ftb)
        extend(stable_top(torch.where(need1, counts1, 0), ftb), p1, w1, need1)
        counts1 = counts_of(d1)

    cap2a = min(max(4 * w1, 192), ncb)
    cap2b = min(512, ncb)
    ft = min(256, nta)
    need_a = counts1 > w1
    overflow = overflow | (need_a.sum() > ft)
    if cap2a > w1 and ft > 0:
        otiles = stable_top(torch.where(need_a, counts1, 0), ft)
        counts2a = counts_of(extend(otiles, 0, cap2a, need_a), otiles)
        if cap2b > cap2a:
            ft2 = min(32, ft)
            need_b = torch.where(counts2a > cap2a, counts2a, 0)
            overflow = overflow | ((need_b > 0).sum() > ft2)
            b2tiles = otiles[stable_top(need_b, ft2)]
            # counts1 of a tile past cap2a is at least its tier-A recount
            counts1 = counts1.index_copy(0, otiles, counts2a)
            counts2b = counts_of(
                extend(b2tiles, 0, cap2b, counts1 > cap2a), b2tiles)
            overflow = overflow | (counts2b > cap2b).any()
        else:
            overflow = overflow | (counts2a > cap2a).any()
    return d1.reshape(nta * CHUNK), i1.reshape(nta * CHUNK), overflow


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
    *,
    prologue: typing.Optional[str] = None,
    sched: typing.Optional[str] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Pruned 1-NN over prebuilt grids, ORIGINAL order, with escalation.

    Returns ``(idx int32 (Pa,), dist_sq (Pa,))``. Building the grids once
    per cloud (``Cloud.get_grid``) shares the Morton sort across every NN
    pass of an evaluation. ``prologue`` and ``sched`` default to
    ``PCC_NN_PROLOGUE`` and ``PCC_NN_SCHED``, read at this call.
    """
    nn = resolve_nn_schedule(prologue=prologue, sched=sched, payload=False,
                             cap=cap, fallback=fallback_tiles)
    return _nn_climb(ga, gb, n_a, exclude_self, nn, gb.n_chunks)


def _nn_climb(ga, gb, n_a, exclude_self, nn: NnSchedule, ncb: int,
              memo=None, key=None):
    """``(idx, dist_sq)`` in ORIGINAL order, climbing from ``nn``'s rung
    with the limits ``(ncb, nta)``."""

    def run(cap, fallback):
        d_s, i_s, overflow = _nn_pruned_sorted(
            ga, gb, n_a, exclude_self,
            nn._replace(cap=cap, fallback=fallback), mxu_ok=False)
        with span("pcc.readback"):
            overflow = bool(overflow)
        return (d_s, i_s), overflow

    (d_s, i_s), _ = climb(run, (nn.cap, nn.fallback), ncb,
                          ga.points.shape[0] // CHUNK, memo, key)
    d, idx = unsort_nn_result(ga, gb, d_s, i_s)
    return idx, d


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
    *,
    prologue: typing.Optional[str] = None,
    sched: typing.Optional[str] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Exact pruned 1-NN in ORIGINAL row order with automatic escalation.

    Returns ``(idx int32 (Pa,), dist_sq (Pa,))``. With ``exclude_self``
    the search runs over ``a`` itself (``b_points`` is not read). An
    overflowing rung escalates through ``next_rung`` until the certificate
    passes or stage 1 covers every search chunk; the rung that worked is
    remembered per problem shape. ``prologue`` and ``sched``
    default to ``PCC_NN_PROLOGUE`` and ``PCC_NN_SCHED``, read at this call.
    """
    nn = resolve_nn_schedule(prologue=prologue, sched=sched, payload=False,
                             cap=cap, fallback=fallback_tiles)
    ga = build_grid(a_points, int(n_a))
    gb = ga if exclude_self else build_grid(b_points, int(n_b))
    # The JAX package's key: both schedules overflow on the same rungs.
    key = (a_points.shape[0], b_points.shape[0], exclude_self)
    return _nn_climb(ga, gb, int(n_a), exclude_self, nn,
                     b_points.shape[0] // CHUNK, _ESCALATION_MEMO, key)
