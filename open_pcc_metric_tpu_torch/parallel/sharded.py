"""Multi-device evaluation: frame groups over mesh rows x a ring over points.

Port of ``open_pcc_metric_tpu/parallel/sharded.py``. The JAX package runs
its ring under ``jax.shard_map``: one program, driven by one process, on
every device of a ("frames", "points") mesh. Here the mesh is the same
single-process picture made of torch devices:

  * ``Mesh.devices`` is a (dp, w) array of torch devices, one slot each. A
    device may fill several slots: ``make_mesh(devices=["cpu"] * 8)`` is the
    counterpart of JAX's virtual CPU devices, and ``make_mesh(devices=
    [torch.device("cuda", 0)] * 4)`` runs a 4-slot ring on one card;
  * frame ``f`` of a batch of B runs on mesh row ``f // (B / dp)``, as
    ``P("frames")`` splits a batch, and each of its clouds is cut into w
    row blocks, block j on slot j (``P("points")``);
  * each ring function takes and returns one tensor per slot of a mesh row:
    a list in ring order, each tensor on its slot's device, so the list is
    the ring's axis; JAX's ``axis`` parameter stays in its place, checked
    and unused;
  * ``lax.ppermute`` is ``_rotate``: after one rotation slot j holds what
    slot j + 1 held (JAX's perm [(i, (i - 1) % w)]). On a repeated device
    the ``.to`` returns the same tensor, which is safe because nothing in
    the ring writes into a tensor it was given;
  * ``psum``/``pmax``/``pmin`` fold the slots' partials in slot order.

Nothing inside a ring step reads a value back to the host, so the slots'
work is queued without waiting and, on a mesh of several cards, overlaps.
The escalation ladder reads the overflow flags once a rung
(``sharded_pair_stats_pruned_auto``).

The pruned ring refines each slot's query tiles through K1
(``ops/refine.refine_nn``) in float32, where the JAX package runs its
Pallas kernel on the TPU: the kernel on a CUDA slot, its plain version on
a CPU slot. Float64 rings take ``refine_nn_reference``, as the JAX
package's take its plain refine (``_refine_local_pallas``).
"""
from __future__ import annotations

import functools
import typing

import numpy as np
import torch

from ..ops.color import transform_colors
from ..ops.eigh3 import smallest_eigenvector_sym3
from ..ops.fused import _sorted_colors, _sorted_normals
from ..ops.grid import CHUNK, bbox_lower_bounds
from ..ops.knn import knn
from ..ops.nn import nn_chunked
from ..ops.nn_pruned import cert_ub, count_under, lb_order
from ..ops.normals import DEFAULT_KNN, cov3
from ..ops.refine import refine_nn, refine_nn_reference
from .._layout_args import check_axis
from ..utils.cache import ladder_lookup, ladder_store

Slots = typing.List[torch.Tensor]

# Bounds the element count of one block of the k-NN merge's distances.
_BLOCK_ELEMS = 1 << 24


class Mesh:
    """A (dp, w) grid of torch devices with the JAX mesh's axis names:
    frame groups along "frames", the ring's slots along "points"."""

    axis_names = ("frames", "points")

    def __init__(self, devices: np.ndarray):
        self.devices = devices


def make_mesh(
    n_devices: typing.Optional[int] = None,
    dp: int = 1,
    *,
    devices: typing.Optional[typing.Sequence] = None,
) -> Mesh:
    """Mesh with axes ("frames", "points"): dp frame groups x ring width.

    ``devices`` lists the slots' devices, and a device may repeat (each
    repeat is one more slot on it); None means every CUDA device, and
    raises when there is none. ``n_devices`` keeps the first that many.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices= (for example "
                "['cpu'] * 8) for a mesh of CPU slots")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, n // dp))


def _rotate(xs: typing.List[typing.Optional[torch.Tensor]]):
    """One ring rotation: slot j receives slot j + 1's tensor on slot j's
    device (JAX's ``ppermute`` with perm [(i, (i - 1) % w)]). A list of
    Nones (no payload) stays as it is."""
    n = len(xs)
    if xs[0] is None:
        return xs
    return [xs[(j + 1) % n].to(xs[j].device, non_blocking=True)
            for j in range(n)]


def _fold(op, xs: Slots) -> torch.Tensor:
    """The slots' partials folded by ``op`` in slot order, on slot 0's
    device (``psum`` with torch.add, ``pmax``, ``pmin``)."""
    dev = xs[0].device
    return functools.reduce(op, (x.to(dev) for x in xs))


def _shard(x: torch.Tensor, devices) -> Slots:
    """One frame's (P, ...) rows cut into len(devices) blocks, block j on
    devices[j] (``P("points")``)."""
    rows = x.shape[0] // len(devices)
    return [x[j * rows:(j + 1) * rows].to(d, non_blocking=True)
            for j, d in enumerate(devices)]


def _better(d, i, best_d, best_i):
    """Rows where (d, i) is lexicographically below (best_d, best_i)."""
    return (d < best_d) | ((d == best_d) & (i < best_i))


def _take_rows(better, new, old):
    """Rows of ``new`` where ``better``, else of ``old`` (any row rank)."""
    return torch.where(better.reshape(better.shape + (1,) * (new.ndim - 1)),
                       new, old)


# ------------------------------------------------------------------ ring 1-NN


def ring_nn(
    a_loc: Slots,
    b_loc: Slots,
    axis: typing.Optional[str] = "points",
    payloads: typing.Tuple[Slots, ...] = (),
    exclude_self: bool = False,
) -> typing.Tuple[Slots, Slots, typing.Tuple[Slots, ...]]:
    """Exact 1-NN of each slot's queries against the FULL ring-sharded cloud.

    ``a_loc`` and ``b_loc`` hold one block of rows per slot. ``payloads``
    are b-aligned per-slot blocks (colours, normals, the points) whose rows
    rotate with ``b_loc``; the returned payloads are each query's winning
    neighbour's rows.

    Returns ``(dist_sq, global_idx, best_payloads)``, one tensor per slot
    (each payload a list of slots). Ties break to the lowest GLOBAL index,
    as the single-device search does. ``axis``, here and in every ring
    function, is the JAX package's ``shard_map`` axis, checked and unused:
    the ring is the slots' list (``_layout_args``).
    """
    check_axis(axis)
    nsh = len(a_loc)
    rows_a, rows_b = a_loc[0].shape[0], b_loc[0].shape[0]
    best_d = [torch.full((rows_a,), torch.inf, dtype=a.dtype, device=a.device)
              for a in a_loc]
    best_i = [torch.zeros(rows_a, dtype=torch.int32, device=a.device)
              for a in a_loc]
    best_pay = [[torch.zeros((rows_a,) + tuple(p[me].shape[1:]),
                             dtype=p[me].dtype, device=a_loc[me].device)
                 for me in range(nsh)] for p in payloads]
    b_cur, pay_cur = list(b_loc), [list(p) for p in payloads]
    for s in range(nsh):
        if s:
            b_cur = _rotate(b_cur)
            pay_cur = [_rotate(p) for p in pay_cur]
        for me in range(nsh):
            b_base = ((me + s) % nsh) * rows_b
            idx, d = nn_chunked(a_loc[me], b_cur[me],
                                exclude_self=exclude_self,
                                a_offset=me * rows_a, b_offset=b_base)
            gidx = idx + b_base
            better = _better(d, gidx, best_d[me], best_i[me])
            best_d[me] = torch.where(better, d, best_d[me])
            best_i[me] = torch.where(better, gidx, best_i[me])
            for bp, pc in zip(best_pay, pay_cur):
                bp[me] = _take_rows(better, pc[me][idx.long()], bp[me])
    return best_d, best_i, tuple(best_pay)


# ---------------------------------------------------------- pruned ring 1-NN


def _tile_bounds_local(a_loc, row0, n_valid):
    """Per-tile bboxes of one slot's Morton-sorted query rows, masked to
    the globally valid rows (sorted row s is valid iff row0 + s < n_valid).
    Returns the (ntl, 256) mask and the (ntl, 3) corners."""
    ntl = a_loc.shape[0] // CHUNK
    big = torch.finfo(a_loc.dtype).max
    valid = ((row0 + torch.arange(a_loc.shape[0], device=a_loc.device))
             < n_valid).reshape(ntl, CHUNK)
    tiles = a_loc.reshape(ntl, CHUNK, 3)
    lo = torch.where(valid[:, :, None], tiles, big).amin(dim=1)
    hi = torch.where(valid[:, :, None], tiles, -big).amax(dim=1)
    return valid, lo, hi


def _refine_local_pallas(a_loc, b_cur, perm_cur, payload_cur, cand, ncand,
                         nsh, exclude_self):
    """One slot's refine of its query tiles against their ``cand`` chunks
    of the held shard ``b_cur``: K1 (``refine_nn``) in float32, which is
    the kernel on a CUDA slot and its plain version on a CPU slot, and
    ``refine_nn_reference`` in float64, which K1 does not take (the JAX
    package's float64 rings run its plain refine too).

    Returns ``(dmin (Pl,), orig_idx (Pl,), pay (Pl, F) or None)`` in local
    sorted order: each query's minimum squared distance, the lowest
    ORIGINAL id among the minima (``perm_cur``), as every single-device
    search ties, and the winner's payload row. That row is found through
    the inverse of ``perm_cur`` (original id -> local row of the shard
    this slot holds now; the refine only ever picks rows of ``b_cur``).
    ``ncand`` gates each tile's live slots (None: all live); a tile gated
    to none returns +inf and INT_MAX, whose clamped payload gather never
    wins a merge. ``exclude_self`` is positional (local query row ==
    candidate row), which is right on the slot's own shard only.
    """
    fn = refine_nn if a_loc.dtype == torch.float32 else refine_nn_reference
    d, ii = fn(a_loc, b_cur, perm_cur, cand.contiguous(), ncand=ncand,
               exclude_self=exclude_self)
    d, ii = d.reshape(-1), ii.reshape(-1)
    if payload_cur is None:
        return d, ii, None
    rows = b_cur.shape[0]
    dev = b_cur.device
    inv = torch.zeros(nsh * rows, dtype=torch.long, device=dev)
    inv[perm_cur.long()] = torch.arange(rows, device=dev)
    return d, ii, payload_cur[inv[ii.long().clamp(0, nsh * rows - 1)]]


# The ring's schedules, by the JAX package's names for the refine routes
# that take them: "pallas" (the kernel route) probes and extends in step 0
# and gates each rotation's tiles to their qualifying chunks, "xla" (the
# plain route) refines all cap0 chunks in step 0 and all cap in a rotation.
REFINE_IMPLS = ("auto", "pallas", "xla")


def _check_refine_impl(impl: str) -> None:
    if impl not in REFINE_IMPLS:
        raise ValueError(f"refine_impl must be one of {REFINE_IMPLS}, "
                         f"got {impl!r}")


def _kernel_schedule(impl: str, device: torch.device,
                     dtype: torch.dtype) -> bool:
    """Whether a slot takes the kernel route's schedule ("pallas" in
    ``REFINE_IMPLS``), which decides the overflow flags, and not the plain
    route's. "auto" takes it on a CUDA slot in float32, where the JAX
    package's "auto" takes its kernel on the TPU, and takes the plain
    route's elsewhere, as the JAX package's "auto" does on the CPU;
    "pallas" takes it on any slot, "xla" never. Float64 never does: the
    JAX package's float64 rings take the plain route whatever is asked.
    Both schedules refine through ``_refine_local_pallas``, so a CUDA slot
    in float32 launches K1 on either. No environment variable is read
    (``PCC_REFINE_IMPL`` chooses single-device schedules the ring does not
    have)."""
    if dtype != torch.float32:
        return False
    if impl == "auto":
        return device.type == "cuda"
    return impl == "pallas"


def _ring_step0_counted(refine, lb0, cand0, p0, cap0, valid_t, b_loc,
                        b_perm, payload, exclude_self):
    """Step 0 in the counted two-pass schedule of the single-device stage 1
    (``ops/nn_pruned.py``): probe the ``p0`` lowest-lb chunks all live, then
    extend each tile in place to its certificate count through K1's
    per-tile gate. Exact: the final ub <= the probe's ub, so every chunk
    qualifying under the final ub lies in the probe-counted lb prefix that
    the extension covered, or counts0 > cap0 flags overflow for the
    caller's ladder. ``refine(b_cur, perm_cur, pay_cur, cand, ncand,
    exclude_self)`` is the slot's refine. Returns (d, ids, payload rows,
    overflow)."""
    ntl = valid_t.shape[0]
    best_d, best_i, best_pay = refine(
        b_loc, b_perm, payload, cand0[:, :p0], None, exclude_self)
    counts0 = count_under(lb0, cert_ub(best_d.reshape(ntl, CHUNK), valid_t))
    ncand_e = torch.clamp(counts0 - p0, 0, cap0 - p0).to(torch.int32)
    d_e, i_e, pay_e = refine(b_loc, b_perm, payload, cand0[:, p0:], ncand_e,
                             exclude_self)
    # Gated-off tiles return +inf / INT_MAX rows and never win the merge.
    better = _better(d_e, i_e, best_d, best_i)
    best_d = torch.where(better, d_e, best_d)
    best_i = torch.where(better, i_e, best_i)
    if best_pay is not None:
        best_pay = _take_rows(better, pay_e, best_pay)
    return best_d, best_i, best_pay, (counts0 > cap0).any()


def ring_nn_pruned(
    a_loc: Slots,
    b_loc: Slots,
    b_perm: Slots,
    b_bb_lo: Slots,
    b_bb_hi: Slots,
    n_a,
    n_b,
    axis: typing.Optional[str] = "points",
    payload: typing.Optional[Slots] = None,
    exclude_self: bool = False,
    cap: int = 16,
    refine_impl: str = "auto",
) -> typing.Tuple[Slots, Slots, typing.Optional[Slots], Slots]:
    """Bound-pruned exact ring 1-NN over Morton-sorted shards.

    Per slot: ``a_loc`` and ``b_loc`` (Pl, 3) sorted rows, ``b_perm`` (Pl,)
    their original global row ids, ``b_bb_lo``/``b_bb_hi`` (Cl, 3) chunk
    boxes, ``payload`` (Pl, F) b-aligned rows; ``n_a``/``n_b`` are the
    global valid counts.

    Step 0 solves the slot's OWN shard (Morton sharding makes it the likely
    home of the NN) under the lb-prefix and count certificate; each later
    rotation refines only the <= ``cap`` chunks whose box bound reaches the
    tile's current ub, normally none or a handful. A skipped chunk has
    lb > ub_s >= ub_final, so it holds no winner; ties are kept because
    chunks qualify at lb <= ub (1 + 8 eps) + 8 eps. If more than ``cap``
    chunks qualify anywhere the result may be inexact and the slot's
    ``overflow`` is set: callers escalate the cap.

    Every slot refines through ``_refine_local_pallas``: K1 on a CUDA slot
    in float32. ``refine_impl`` picks the schedule (``_kernel_schedule``);
    a value not in ``REFINE_IMPLS`` raises ValueError.

    Returns ``(dist_sq, orig_idx, payload rows or None, overflow)``, one
    per slot, in local sorted order; ties to the lowest ORIGINAL index,
    bit for bit the single-device searches'.
    """
    check_axis(axis)
    _check_refine_impl(refine_impl)
    nsh = len(a_loc)
    pl_rows = a_loc[0].shape[0]
    ntl = pl_rows // CHUNK
    ncl = b_loc[0].shape[0] // CHUNK
    n_a = int(n_a)
    cap = int(min(cap, ncl))
    cap0 = int(min(max(4 * cap, 64), ncl))
    p0 = min(8, cap0)
    pay = list(payload) if payload is not None else [None] * nsh

    slots = []
    for me in range(nsh):
        a = a_loc[me]
        valid_t, a_lo, a_hi = _tile_bounds_local(a, me * pl_rows, n_a)

        def refine(b_cur, perm_cur, pay_cur, cand, ncand, excl, a=a):
            return _refine_local_pallas(a, b_cur, perm_cur, pay_cur, cand,
                                        ncand, nsh, excl)

        gated = _kernel_schedule(refine_impl, a.device, a.dtype)
        lb0 = bbox_lower_bounds(a_lo, a_hi, b_bb_lo[me], b_bb_hi[me])
        cand0 = lb_order(lb0)[:, :cap0]
        if gated and cap0 > p0:
            d, i, p, ovf = _ring_step0_counted(
                refine, lb0, cand0, p0, cap0, valid_t, b_loc[me], b_perm[me],
                pay[me], exclude_self)
        else:
            d, i, p = refine(b_loc[me], b_perm[me], pay[me], cand0, None,
                             exclude_self)
            ovf = (count_under(lb0, cert_ub(d.reshape(ntl, CHUNK), valid_t))
                   > cap0).any()
        slots.append([valid_t, a_lo, a_hi, refine, gated, d, i, p, ovf])

    cur = (list(b_loc), list(b_perm), list(b_bb_lo), list(b_bb_hi), pay)
    for s in range(1, nsh):
        cur = tuple(_rotate(x) for x in cur)
        for me, slot in enumerate(slots):
            valid_t, a_lo, a_hi, refine, gated, bd, bi, bp, ovf = slot
            b_cur, perm_cur, lo_cur, hi_cur, pay_cur = (x[me] for x in cur)
            lb = bbox_lower_bounds(a_lo, a_hi, lo_cur, hi_cur)
            qual = lb <= cert_ub(bd.reshape(ntl, CHUNK), valid_t)[:, None]
            counts = qual.sum(dim=1, dtype=torch.int32)
            ovf = ovf | (counts > cap).any()
            cand = lb_order(torch.where(qual, lb, torch.inf))[:, :cap]
            # excl=False: a query's own row lives only in its own shard
            # (step 0), and K1's self-mask is positional, so it would mask
            # aligned rows of OTHER shards here. Ungated (the plain route),
            # tiles with fewer qualifying chunks still refine cap: real
            # distances, which lose the merge on every valid row.
            ncand = (torch.clamp(counts, max=cap).to(torch.int32) if gated
                     else None)
            d, ii, p = refine(b_cur, perm_cur, pay_cur, cand, ncand, False)
            better = _better(d, ii, bd, bi)
            slot[5:] = [torch.where(better, d, bd),
                        torch.where(better, ii, bi),
                        None if bp is None else _take_rows(better, p, bp), ovf]
    return ([s[5] for s in slots], [s[6] for s in slots],
            None if payload is None else [s[7] for s in slots],
            [s[8] for s in slots])


# ------------------------------------------------------------------ ring k-NN


def _knn_merge(a_loc, run_d, run_c, cand, b_cur, k):
    """Merge each tile's running k-buffer (ntl, 256, k) with the points of
    its ``cand`` chunks: the k smallest distances of buffer then candidates,
    ties to the earlier position (XLA ``top_k``'s order), and their
    coordinates."""
    ntl, kk = cand.shape
    dev = a_loc.device
    b_chunks = b_cur.reshape(-1, CHUNK, 3)
    a_tiles = a_loc.reshape(ntl, CHUNK, 3)
    out_d, out_c = torch.empty_like(run_d), torch.empty_like(run_c)
    bt = max(1, _BLOCK_ELEMS // (CHUNK * (k + kk * CHUNK)))
    for s in range(0, ntl, bt):
        e = min(ntl, s + bt)
        n = e - s
        q = a_tiles[s:e]
        cpts = b_chunks[cand[s:e].long()].reshape(n, kk * CHUNK, 3)
        d = None
        for c in range(3):
            diff = q[:, :, None, c] - cpts[:, None, :, c]
            d = diff * diff if d is None else d + diff * diff
        top, pos = torch.sort(torch.cat([run_d[s:e], d], dim=2), dim=2,
                              stable=True)
        top, pos = top[..., :k], pos[..., :k]
        from_run = (pos < k)[..., None]
        kept = torch.gather(run_c[s:e], 2, pos.clamp(max=k - 1)[..., None]
                            .expand(-1, -1, -1, 3))
        batch = torch.arange(n, device=dev)[:, None, None]
        new = cpts[batch, (pos - k).clamp(min=0)]
        out_d[s:e] = top
        out_c[s:e] = torch.where(from_run, kept, new)
    return out_d, out_c


def ring_knn_coords_pruned(
    a_loc: Slots,
    b_loc: Slots,
    b_bb_lo: Slots,
    b_bb_hi: Slots,
    n_a,
    k: int,
    axis: typing.Optional[str] = "points",
    cap: int = 16,
) -> typing.Tuple[Slots, Slots, Slots]:
    """Bound-pruned ring k-NN COORDINATES (normal estimation's search).

    ``ring_nn_pruned``'s structure with the tile ub taken from the running
    k-th neighbour distance. Returns ``(dists (Pl, k), coords (Pl, k, 3),
    overflow)`` per slot, ascending; self-inclusive (Open3D's semantics),
    coordinates only, so no cross-shard gather.
    """
    check_axis(axis)
    nsh = len(a_loc)
    pl_rows = a_loc[0].shape[0]
    ntl = pl_rows // CHUNK
    ncl = b_loc[0].shape[0] // CHUNK
    n_a = int(n_a)
    cap = int(min(cap, ncl))
    cap0 = int(min(max(4 * cap, 64), ncl))

    slots = []
    for me in range(nsh):
        a = a_loc[me]
        valid_t, a_lo, a_hi = _tile_bounds_local(a, me * pl_rows, n_a)
        lb0 = bbox_lower_bounds(a_lo, a_hi, b_bb_lo[me], b_bb_hi[me])
        run_d = torch.full((ntl, CHUNK, k), torch.inf, dtype=a.dtype,
                           device=a.device)
        run_c = torch.zeros((ntl, CHUNK, k, 3), dtype=a.dtype,
                            device=a.device)
        run_d, run_c = _knn_merge(a, run_d, run_c, lb_order(lb0)[:, :cap0],
                                  b_loc[me], k)
        ovf = (count_under(lb0, cert_ub(run_d[..., k - 1], valid_t))
               > cap0).any()
        slots.append([valid_t, a_lo, a_hi, run_d, run_c, ovf])

    cur = (list(b_loc), list(b_bb_lo), list(b_bb_hi))
    for _ in range(1, nsh):
        cur = tuple(_rotate(x) for x in cur)
        for me, slot in enumerate(slots):
            valid_t, a_lo, a_hi, run_d, run_c, ovf = slot
            b_cur, lo_cur, hi_cur = (x[me] for x in cur)
            lb = bbox_lower_bounds(a_lo, a_hi, lo_cur, hi_cur)
            qual = lb <= cert_ub(run_d[..., k - 1], valid_t)[:, None]
            ovf = ovf | (qual.sum(dim=1) > cap).any()
            cand = lb_order(torch.where(qual, lb, torch.inf))[:, :cap]
            slot[3:] = [*_knn_merge(a_loc[me], run_d, run_c, cand, b_cur, k),
                        ovf]
    return ([s[3].reshape(pl_rows, k) for s in slots],
            [s[4].reshape(pl_rows, k, 3) for s in slots],
            [s[5] for s in slots])


def ring_knn_coords(
    a_loc: Slots,
    b_loc: Slots,
    k: int,
    axis: typing.Optional[str] = "points",
) -> typing.Tuple[Slots, Slots]:
    """k nearest NEIGHBOUR COORDINATES from the full ring-sharded cloud.

    Carrying coordinates (not global indices) avoids any cross-shard
    gather: the covariance of normal estimation needs only the coordinates.
    Returns ``(dists (Na_loc, k), coords (Na_loc, k, 3))`` per slot,
    ascending, ties to the earlier candidate (the running buffer first).
    """
    check_axis(axis)
    nsh = len(a_loc)
    run_d = [torch.full((a.shape[0], k), torch.inf, dtype=a.dtype,
                        device=a.device) for a in a_loc]
    run_c = [torch.zeros((a.shape[0], k, 3), dtype=a.dtype, device=a.device)
             for a in a_loc]
    b_cur = list(b_loc)
    for s in range(nsh):
        if s:
            b_cur = _rotate(b_cur)
        for me in range(nsh):
            idx, d = knn(a_loc[me], b_cur[me], k=k)
            cand_c = torch.cat([run_c[me], b_cur[me][idx.long()]], dim=1)
            top, pos = torch.sort(torch.cat([run_d[me], d], dim=1), dim=1,
                                  stable=True)
            run_d[me] = top[:, :k]
            run_c[me] = torch.gather(
                cand_c, 1, pos[:, :k, None].expand(-1, -1, 3))
    return run_d, run_c


def _pca_normals(coords: torch.Tensor, k: int) -> torch.Tensor:
    """(P, k, 3) neighbourhoods -> (P, 3) PCA normals: the mean and the
    population covariance by true divisions, covariance sums elementwise
    (``cov3``: no matrix product)."""
    kk = torch.tensor(float(k), dtype=coords.dtype, device=coords.device)
    centered = coords - coords.sum(dim=1, keepdim=True) / kk
    return smallest_eigenvector_sym3(cov3(centered) / kk)


def ring_normals(points_loc: Slots, k: int = DEFAULT_KNN,
                 axis: typing.Optional[str] = "points") -> Slots:
    """PCA normals of a ring-sharded cloud (local queries, global k-NN)."""
    _, coords = ring_knn_coords(points_loc, points_loc, k=k, axis=axis)
    return [_pca_normals(c, k) for c in coords]


def ring_normals_pruned(
    pts_sorted_loc: Slots,
    bb_lo: Slots,
    bb_hi: Slots,
    n_valid,
    k: int = DEFAULT_KNN,
    axis: typing.Optional[str] = "points",
    cap: int = 16,
) -> typing.Tuple[Slots, Slots]:
    """PCA normals of a Morton-sorted ring-sharded cloud, bound-pruned:
    ``(normals, overflow)`` per slot."""
    _, coords, ovf = ring_knn_coords_pruned(
        pts_sorted_loc, pts_sorted_loc, bb_lo, bb_hi, n_valid, k=k,
        axis=axis, cap=cap)
    return [_pca_normals(c, k) for c in coords], ovf


# ------------------------------------------------------- full sharded step


def _local_masked_sum(x, mask):
    m = mask if x.ndim == 1 else mask[:, None]
    return torch.where(m, x, 0).sum(dim=0)


def _local_masked_max(x, mask):
    m = mask if x.ndim == 1 else mask[:, None]
    return torch.where(m, x, -torch.inf).amax(dim=0)


def _allsum(xs: Slots, masks: Slots) -> torch.Tensor:
    return _fold(torch.add, [_local_masked_sum(x, m)
                             for x, m in zip(xs, masks)])


def _allmax(xs: Slots, masks: Slots) -> torch.Tensor:
    return _fold(torch.maximum, [_local_masked_max(x, m)
                                 for x, m in zip(xs, masks)])


def _row_masks(like: Slots, n: int) -> Slots:
    """Each slot's mask of globally valid rows (global row < n)."""
    rows = like[0].shape[0]
    return [(me * rows + torch.arange(rows, device=x.device)) < n
            for me, x in enumerate(like)]


def _boundary_stats(out, sqrt_self: Slots, mask_a: Slots) -> None:
    """The intra-origin NN entries (Hausdorff peak, min_sqrt, max_sqrt)."""
    out["self_min"] = _fold(torch.minimum, [
        torch.where(m, s, torch.inf).amin() for s, m in zip(sqrt_self,
                                                            mask_a)])
    out["self_max"] = _allmax(sqrt_self, mask_a)


def _colour_stats(out, a_col, b_col, nc0, nc1, mask_a, mask_b,
                  color_scheme) -> None:
    """The colour entries: each query's colour against its neighbour's
    (``nc0``/``nc1``), both transformed to ``color_scheme``."""
    def diffs(cols, nn_cols):
        return [transform_colors(c, "rgb", color_scheme)
                - transform_colors(nc, "rgb", color_scheme)
                for c, nc in zip(cols, nn_cols)]

    diff0, diff1 = diffs(a_col, nc0), diffs(b_col, nc1)
    out["c_sse_l"] = _allsum([x**2 for x in diff0], mask_a)
    out["c_sse_r"] = _allsum([x**2 for x in diff1], mask_b)
    if color_scheme == "rgb":  # SURVEY Q5 quirk
        diff0 = [255.0 * x for x in diff0]
        diff1 = [255.0 * x for x in diff1]
    out["c_max_l"] = _allmax([x**2 for x in diff0], mask_a)
    out["c_max_r"] = _allmax([x**2 for x in diff1], mask_b)


def _d2_stats(out, a_pts, b_pts, nnb, nna, n_for_0, n_for_1, mask_a, mask_b):
    """The point-to-plane entries: each query's error to its neighbour
    projected on the given normals, squared."""
    p0 = [((a - nb) * n).sum(dim=1) ** 2
          for a, nb, n in zip(a_pts, nnb, n_for_0)]
    p1 = [((b - na) * n).sum(dim=1) ** 2
          for b, na, n in zip(b_pts, nna, n_for_1)]
    out["d2_sse_l"] = _allsum(p0, mask_a)
    out["d2_sse_r"] = _allsum(p1, mask_b)
    out["d2_max_l"] = _allmax(p0, mask_a)
    out["d2_max_r"] = _allmax(p1, mask_b)


def _frame_stats(
    a_pts, b_pts, n_a, n_b, a_col, b_col, a_nrm, b_nrm,
    *, color_scheme, point_to_plane, d2_mode,
):
    """One frame's stats on one mesh row through the brute ring: every
    argument but the counts is a list of slots.

    Both clouds share one padded size and the same sharding, so the
    reference-mode D2 positional normal lookup (SURVEY Q3) is slot-local:
    slot i of A's queries aligns with slot i of B's normals.
    """
    mask_a, mask_b = _row_masks(a_pts, n_a), _row_masks(b_pts, n_b)
    pay_b: list = []
    pay_a: list = []
    if color_scheme is not None:
        pay_b.append(b_col)
        pay_a.append(a_col)
    need_nn_normals = point_to_plane and d2_mode == "pc_error"
    if point_to_plane:
        if a_nrm is None:
            a_nrm = ring_normals(a_pts)
        if b_nrm is None:
            b_nrm = ring_normals(b_pts)
    if need_nn_normals:
        pay_b.append(b_nrm)
        pay_a.append(a_nrm)
    if point_to_plane:
        pay_b.append(b_pts)  # the neighbours' coordinates, for D2 errors
        pay_a.append(a_pts)

    d0, _, pay0 = ring_nn(a_pts, b_pts, payloads=tuple(pay_b))
    d1, _, pay1 = ring_nn(b_pts, a_pts, payloads=tuple(pay_a))
    out = {
        "n_a": n_a,
        "n_b": n_b,
        "d1_sse_l": _allsum(d0, mask_a),
        "d1_sse_r": _allsum(d1, mask_b),
        "d1_max_l": _allmax(d0, mask_a),
        "d1_max_r": _allmax(d1, mask_b),
    }
    dself, _, _ = ring_nn(a_pts, a_pts, exclude_self=True)
    _boundary_stats(out, [torch.sqrt(d) for d in dself], mask_a)
    k = 0
    if color_scheme is not None:
        _colour_stats(out, a_col, b_col, pay0[0], pay1[0], mask_a, mask_b,
                      color_scheme)
        k = 1
    if point_to_plane:
        if need_nn_normals:
            n_for_0, n_for_1 = pay0[k], pay1[k]
            k += 1
        else:
            n_for_0, n_for_1 = b_nrm, a_nrm  # positional, shard-aligned
        _d2_stats(out, a_pts, b_pts, pay0[k], pay1[k], n_for_0, n_for_1,
                  mask_a, mask_b)
    return out


def _frame_stats_sorted(
    a_s, b_s, a_perm, b_perm, a_lo, a_hi, b_lo, b_hi, n_a, n_b,
    a_col_s, b_col_s, a_nrm_s, b_nrm_s, nrm_for_a, nrm_for_b,
    *, color_scheme, point_to_plane, d2_mode, cap, refine_impl="auto",
):
    """One frame's stats on one mesh row through the pruned ring over
    MORTON-SORTED shards (every argument but the counts a list of slots).

    Every reduction is permutation-invariant over queries, so the sorted
    order needs no unsort; validity is ``global sorted row < n`` (sentinels
    sort last). The reference-mode D2 positional normals (SURVEY Q3) come
    pre-gathered into the QUERY cloud's sorted order (``nrm_for_*``), so
    they shard with the queries.
    """
    mask_a, mask_b = _row_masks(a_s, n_a), _row_masks(b_s, n_b)
    overflows = []
    need_nn_normals = point_to_plane and d2_mode == "pc_error"
    if point_to_plane and d2_mode == "reference" and (
        nrm_for_a is None or nrm_for_b is None
    ):
        # In-mesh estimation gives normals in each cloud's OWN sorted order;
        # the positional pairing needs the OPPOSITE cloud's normals at the
        # query's original row, which only pack_sorted_frames pre-gathers.
        raise ValueError(
            "reference-mode D2 on sorted shards requires pre-gathered "
            "positional normals (nrm_for_a/nrm_for_b); pack frames with "
            "pack_sorted_frames(point_to_plane=True, d2_mode='reference') "
            "or use d2_mode='pc_error'"
        )
    if point_to_plane and a_nrm_s is None:
        a_nrm_s, ovf = ring_normals_pruned(a_s, a_lo, a_hi, n_a, cap=cap)
        overflows += ovf
    if point_to_plane and b_nrm_s is None:
        b_nrm_s, ovf = ring_normals_pruned(b_s, b_lo, b_hi, n_b, cap=cap)
        overflows += ovf

    def build_payload(pts, col, nrm):
        parts = []
        if color_scheme is not None:
            parts.append(col)
        if need_nn_normals:
            parts.append(nrm)
        if point_to_plane:
            parts.append(pts)
        if not parts:
            return None
        return [torch.cat(p, dim=1) for p in zip(*parts)]

    def split_payload(pay):
        out: typing.Dict[str, Slots] = {}
        if pay is None:
            return out
        c = 0
        for name, wanted in (("col", color_scheme is not None),
                             ("nrm", need_nn_normals),
                             ("pts", point_to_plane)):
            if wanted:
                out[name] = [p[:, c:c + 3] for p in pay]
                c += 3
        return out

    d0, _, pr0, ovf0 = ring_nn_pruned(
        a_s, b_s, b_perm, b_lo, b_hi, n_a, n_b,
        payload=build_payload(b_s, b_col_s, b_nrm_s), cap=cap,
        refine_impl=refine_impl)
    d1, _, pr1, ovf1 = ring_nn_pruned(
        b_s, a_s, a_perm, a_lo, a_hi, n_b, n_a,
        payload=build_payload(a_s, a_col_s, a_nrm_s), cap=cap,
        refine_impl=refine_impl)
    overflows += ovf0 + ovf1
    pay0, pay1 = split_payload(pr0), split_payload(pr1)
    out = {
        "n_a": n_a,
        "n_b": n_b,
        "d1_sse_l": _allsum(d0, mask_a),
        "d1_sse_r": _allsum(d1, mask_b),
        "d1_max_l": _allmax(d0, mask_a),
        "d1_max_r": _allmax(d1, mask_b),
    }
    dself, _, _, ovf2 = ring_nn_pruned(
        a_s, a_s, a_perm, a_lo, a_hi, n_a, n_a, exclude_self=True, cap=cap,
        refine_impl=refine_impl)
    overflows += ovf2
    _boundary_stats(out, [torch.sqrt(torch.clamp(d, min=0.0)) for d in dself],
                    mask_a)
    if color_scheme is not None:
        _colour_stats(out, a_col_s, b_col_s, pay0["col"], pay1["col"], mask_a,
                      mask_b, color_scheme)
    if point_to_plane:
        if need_nn_normals:
            n_for_0, n_for_1 = pay0["nrm"], pay1["nrm"]
        else:
            n_for_0, n_for_1 = nrm_for_a, nrm_for_b  # positional, pre-gathered
        _d2_stats(out, a_s, b_s, pay0["pts"], pay1["pts"], n_for_0, n_for_1,
                  mask_a, mask_b)
    out["nn_overflow"] = _fold(torch.logical_or, overflows)
    return out


PACKED_KEYS = ("a_s", "b_s", "a_perm", "b_perm", "a_lo", "a_hi", "b_lo",
               "b_hi", "n_a", "n_b", "a_col_s", "b_col_s", "a_nrm_s",
               "b_nrm_s", "nrm_for_a", "nrm_for_b")


def pack_sorted_frames(
    a_clouds, b_clouds, color_scheme=None, point_to_plane=False,
    d2_mode="reference",
):
    """Stack per-frame Morton-sorted tensors for sharded_pair_stats_pruned.

    All clouds must share one padded size (run_sweep_sharded pads a group to
    a common multiple of slots x 256). Uses each Cloud's cached grid and
    gathers the sorted colours and normals and, for reference-mode D2, the
    opposite cloud's positional normals into query-sorted order, on the
    clouds' device. The counts ``n_a``/``n_b`` are (B,) CPU tensors.
    """
    frames: typing.Dict[str, list] = {k: [] for k in PACKED_KEYS}
    for a, b in zip(a_clouds, b_clouds):
        ga, gb = a.get_grid(), b.get_grid()
        frames["a_s"].append(ga.points)
        frames["b_s"].append(gb.points)
        frames["a_perm"].append(ga.perm)
        frames["b_perm"].append(gb.perm)
        frames["a_lo"].append(ga.bbox_lo)
        frames["a_hi"].append(ga.bbox_hi)
        frames["b_lo"].append(gb.bbox_lo)
        frames["b_hi"].append(gb.bbox_hi)
        frames["n_a"].append(a.n)
        frames["n_b"].append(b.n)
        if color_scheme is not None:
            frames["a_col_s"].append(_sorted_colors(a))
            frames["b_col_s"].append(_sorted_colors(b))
        if point_to_plane:
            # Normals for EVERY frame (all or nothing across the group, so
            # the stacks stay frame-aligned): the file's, else the Cloud's
            # cached estimate, as the single-device path estimates when a
            # file has none (reference cloud_pair.py:61-64). Callers who
            # want in-mesh ring estimation (pc_error mode) can delete
            # a_nrm_s/b_nrm_s from the packed dict.
            an, bn = a.get_normals(), b.get_normals()
            frames["a_nrm_s"].append(_sorted_normals(a, an))
            frames["b_nrm_s"].append(_sorted_normals(b, bn))
            if d2_mode == "reference":
                # Q3 positional pairing: the OPPOSITE cloud's normals at the
                # query's original row, in query-sorted order.
                frames["nrm_for_a"].append(bn[ga.perm.long()])
                frames["nrm_for_b"].append(an[gb.perm.long()])
    packed: typing.Dict[str, typing.Optional[torch.Tensor]] = {}
    for k, v in frames.items():
        if not v:
            packed[k] = None
        elif k in ("n_a", "n_b"):
            packed[k] = torch.tensor(v)
        else:
            packed[k] = torch.stack(v)
    return packed


def _host_counts(n) -> typing.List[int]:
    """Per-frame valid counts as Python ints (one readback of a device
    tensor, before any ring work is queued)."""
    return [int(v) for v in torch.as_tensor(n).reshape(-1).tolist()]


def _check_reference_counts(n_a, n_b) -> None:
    """Reference-mode D2 reads the OTHER cloud's normals at the query's own
    row (SURVEY Q3): rows beyond n_b hold padding, so n_a <= n_b per frame,
    as the single-device paths require."""
    for f, (na, nb) in enumerate(zip(n_a, n_b)):
        if na > nb:
            raise IndexError(
                "reference D2 mode requires n_origin <= n_reconst per frame "
                f"(frame {f}: {na} > {nb}); use d2_mode='pc_error'"
            )


def _map_frames(mesh: Mesh, n_frames: int, frame_fn):
    """Run ``frame_fn(f, row_devices)`` for each frame on its mesh row
    (frame f on row f // (B / dp), as ``P("frames")`` splits a batch) and
    stack each stat over the frames, (B,) or (B, 3), on slot (0, 0)'s
    device."""
    dp = mesh.devices.shape[0]
    if n_frames % dp:
        raise ValueError(f"{n_frames} frames do not split over dp={dp} "
                         "mesh rows")
    per_row = n_frames // dp
    outs = [frame_fn(f, list(mesh.devices[f // per_row]))
            for f in range(n_frames)]
    dev = mesh.devices[0, 0]
    return {k: torch.stack([torch.as_tensor(o[k]).to(dev) for o in outs])
            for k in outs[0]}


def sharded_pair_stats_pruned(
    mesh: Mesh,
    packed: typing.Dict[str, typing.Optional[torch.Tensor]],
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    d2_mode: str = "reference",
    cap: int = 16,
    refine_impl: str = "auto",
) -> typing.Dict[str, torch.Tensor]:
    """Bound-pruned multi-device metric evaluation over sorted shards.

    ``packed`` comes from pack_sorted_frames. Returns the stats of
    sharded_pair_stats plus ``nn_overflow`` (B,): frames with True must be
    evaluated again with a larger ``cap`` (run_sweep_sharded escalates).
    ``refine_impl``: the slots' schedule (``_kernel_schedule``); every slot
    refines through K1 in float32 (the kernel on a CUDA slot).
    """
    _check_refine_impl(refine_impl)
    n_a, n_b = _host_counts(packed["n_a"]), _host_counts(packed["n_b"])
    if point_to_plane and d2_mode == "reference":
        _check_reference_counts(n_a, n_b)

    def frame(f, devices):
        args = []
        for k in PACKED_KEYS:
            if k in ("n_a", "n_b"):
                args.append((n_a if k == "n_a" else n_b)[f])
            elif packed.get(k) is None:
                args.append(None)
            else:
                args.append(_shard(packed[k][f], devices))
        return _frame_stats_sorted(
            *args, color_scheme=color_scheme, point_to_plane=point_to_plane,
            d2_mode=d2_mode, cap=cap, refine_impl=refine_impl)

    return _map_frames(mesh, len(n_a), frame)


# Rung memo of the sharded escalation ladder, keyed per problem shape (the
# discipline of ops/nn_pruned.py's _ESCALATION_MEMO).
_RING_LADDER: typing.Dict[tuple, tuple] = {}


def sharded_pair_stats_pruned_auto(
    mesh: Mesh,
    packed: typing.Dict[str, typing.Optional[torch.Tensor]],
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    d2_mode: str = "reference",
    cap: int = 16,
    refine_impl: str = "auto",
) -> typing.Dict[str, torch.Tensor]:
    """sharded_pair_stats_pruned with the cap-escalation ladder and a rung
    memo: one evaluation and one overflow readback a rung, starting from
    the cap that settled last time for this problem shape (``ladder_lookup``
    retries the base rung now and then, so one pathological frame group
    cannot pin the expensive rung).

    Exact on return: once ``cap >= ncl`` (chunks a slot) no ring step can
    overflow, so the ladder ends certified.
    """
    nsh = mesh.devices.shape[1]
    ncl = packed["b_s"].shape[1] // (nsh * CHUNK)
    key = (
        mesh.devices.shape,
        tuple(packed["a_s"].shape), tuple(packed["b_s"].shape),
        color_scheme, point_to_plane, d2_mode, refine_impl,
    )
    cap = min(ladder_lookup(_RING_LADDER, key, cap), max(ncl, 1))
    while True:
        stats = sharded_pair_stats_pruned(
            mesh, packed, color_scheme=color_scheme,
            point_to_plane=point_to_plane, d2_mode=d2_mode, cap=cap,
            refine_impl=refine_impl)
        if cap >= ncl or not bool(stats["nn_overflow"].any()):
            ladder_store(_RING_LADDER, key, cap)
            return stats
        cap = min(cap * 4, ncl)


def sharded_pair_stats(
    mesh: Mesh,
    a_pts: torch.Tensor,  # (B, P, 3)
    b_pts: torch.Tensor,  # (B, P, 3): the same padded P as a_pts
    n_a,  # (B,)
    n_b,  # (B,)
    a_col: typing.Optional[torch.Tensor] = None,
    b_col: typing.Optional[torch.Tensor] = None,
    a_nrm: typing.Optional[torch.Tensor] = None,
    b_nrm: typing.Optional[torch.Tensor] = None,
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    d2_mode: str = "reference",
) -> typing.Dict[str, torch.Tensor]:
    """Batched multi-device metric evaluation through the brute ring: frame
    groups over mesh rows, each frame's points over a row's slots.

    Returns per-frame stats of shape (B,) [or (B, 3) for colour] on slot
    (0, 0)'s device, feedable to ops.fused.finalize_stats frame by frame.
    """
    n_a, n_b = _host_counts(n_a), _host_counts(n_b)
    if point_to_plane and d2_mode == "reference":
        _check_reference_counts(n_a, n_b)

    def frame(f, devices):
        def part(x):
            return None if x is None else _shard(x[f], devices)

        return _frame_stats(
            part(a_pts), part(b_pts), n_a[f], n_b[f], part(a_col),
            part(b_col), part(a_nrm), part(b_nrm), color_scheme=color_scheme,
            point_to_plane=point_to_plane, d2_mode=d2_mode)

    return _map_frames(mesh, len(n_a), frame)
