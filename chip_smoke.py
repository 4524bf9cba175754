#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (open_pcc_metric_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``open_pcc_metric_tpu_torch/csrc``
(one nvcc per source, all started together), checks each against its plain
PyTorch version at the shapes the evaluation paths give it, and drives the
paths on bench.py's voxelised pairs (ycc + point-to-plane + pc_error +
Hausdorff):

  * the main path: ``fused_evaluate`` on the 800k pair with normals (K1),
    with the three NN sweeps checked against an exact float64 scipy oracle
    and the PSNRs against a float64 numpy evaluation;
  * the estimation path: the same pair without normals, fresh clouds per
    run, so each run estimates 30-NN PCA normals (K3, K4) before the
    sweeps (K1); the k-NN sets are checked against an exact float64 scipy
    oracle, the normals against float64 LAPACK normals of those sets, and
    the PSNRs against a float64 evaluation with those normals;
  * the small-cloud path: ``fused_evaluate`` on the 60k pair, the largest
    the brute force serves (61440 padded rows, below 65536), through K5,
    with the same oracle checks;
  * the DAG path: ``evaluate_pair(engine="dag")`` on the 60k pair (K5) and
    on the 800k pair (K1 through ``nn_pruned_with_grids``), each table
    equal to the fused engine's;
  * the brute 30-NN (K8, ``knn_brute_phases``): self searches at the
    brute path's sizes (57344 and 14336 rows, the QP 18 and QP 30 frames
    of an 800k origin, float and shuffled clouds) bit-identical to
    ``knn_chunked``, the QP 18 frame's normals through K8 equal to the
    plain path's, and the small-cloud estimation path: ``fused_evaluate``
    on the 800k origin and its QP 18 frame without normals, fresh clouds
    every call, one warm-up and RUNS timed calls with the plain versions
    guarded, one K8 launch a call;
  * the PLY decode (K9, ``ply_decode_phases``): the 800k original and its
    QP 6 frame loaded from file to device by K9 and by the host path, bit
    for bit, with the pinned read, the copy and the kernel timed apart;
  * the select-prologue paths (``PCC_NN_PROLOGUE=select`` and
    ``PCC_KNN_PROLOGUE=select``, K2a and K2b): the 800k pair with normals
    and the 800k estimation path, in turns with the default prologue, and
    the 2M pair (``bench.make_clouds(2_000_000)``) with normals; every
    sweep and k-NN set bit-identical to the default prologue's, with a
    stage split (prologue, K1, rest) of each 2M sweep. Before them, K2a and
    K2b against their plain versions at the prologue's shapes, K2a also
    above its shared-key limit (64 random tiles against 60000 random chunk
    boxes, cap 32 and 1024, where it takes its first design), and the
    prologue A/B: ``tile_bounds`` (lb, stable sort, two counts) against
    K2a plus two K2b counts, per sweep at 800k and 2M;
  * the refine schedules: ``PCC_REFINE_IMPL=adaptive`` (K7, on these
    integer clouds) on the 800k pair in turns (adaptive, default, default,
    adaptive) and on the 2M pair (adaptive, default), with each sweep's P3
    tail; ``PCC_PAYLOAD_KERNEL=1`` (K6 on the cross sweeps) on the 800k pair
    in turns; every table and sweep bit-identical to the default's, and a
    float pair under adaptive, which must take the default schedule.
    Before them, K7 (P1, P2, P3 seeded beyond cap and from scratch, self
    probe; each at the automatic split and at one block a row), K1's
    expanded mode and K6 (stage 1 a->b and b->a) against their plain
    versions at those shapes, with bounds from what their word skips
    cannot avoid.
    The ladder memo's key names the schedule, so no turn starts from a rung
    another schedule certified;
  * the fixed-cap schedule: ``PCC_NN_SCHED=fixed`` (stage 1 is K2c's
    candidates and one K1b launch) on the 800k pair with normals in turns
    (fixed, default, default, fixed), table and sweeps bit-identical to the
    default's, with a per-sweep split against the counted schedule; and
    ``PCC_NN_SCHED=fixed PCC_KNN_SCHED=fixed`` on the estimation path (K3b),
    k-NN sets equal to the default's, with one profiled cold call. Before
    them, K2c (800k and 2M, cap 32, 64 and 512) against its plain version,
    its first design (``rounds=True``) and a stable sort, K1b and K1c (both
    also at one block a tile) against their plain version and K1 ungated, and
    K3b (800k a->a, float and reconst b->b; with and without its slot
    skip) against its plain version and K3 ungated, on the fixed stage-1
    tables. K1c has no caller in either package, so no path launches it;
  * the QP sweep (``examples/qp_sweep.py``'s workflow) through the port:
    ``datasets.write_qp_sweep`` at 800k points (the reference with
    normals, six degraded frames without), ``batch.run_sweep`` over them
    (K1, K3 and K4 launched, no error record), each record bit-equal to a
    fresh ``fused_evaluate`` of its files loaded wide at the same pad, the
    qp04 pair against a float64 oracle, a resumed sweep that evaluates
    nothing, ``pad="per-pair"`` against ``pad="common"``, the sweep CLI's
    journal equal to ``run_sweep``'s, and the thin upload of the reference
    timed against the wide one and bit-identical to it; then
    ``batch.run_sweep_sharded`` over the same files on a (2, 1) mesh of
    cuda:0 slots, each record within PSNR_TOL dB of ``run_sweep``'s with
    min_sqrt and max_sqrt equal;
  * the ring (``parallel/sharded.py``, one process driving a mesh whose
    slots are torch devices): ``sharded_pair_stats_pruned_auto`` on the
    800k pair with normals on a 1-slot mesh and a 4-slot ring on cuda:0
    (K1 on every slot), every stat within RING_RTOL of the single-device
    ``pair_stats``, the a->b ring bit-identical on valid rows to
    ``nn_pruned_sorted``, and each of its K1 calls (captured: 200k-row
    slots, rotated original ids, count-gated tables) bit-identical to the
    plain version on the same inputs on valid rows, payload rows too; the
    brute ring (``sharded_pair_stats``, plain torch as the JAX package's
    is XLA) on the 60k pair against the fused path's stats;
    ``ring_normals_pruned`` on 60k origins of three seeds against the
    single-device estimate, and the 30-NN sets behind them against a
    single-device search on the rows whose set no tie order changes;
  * the cold-pair fold: ``fused_evaluate`` on fresh 800k clouds without
    normals through ``cold_pair_program`` and stepwise in COLD_PAIRS
    alternating pairs, each call's wall split at its last readback and at
    the end of its OBB thread, tables, normals and 30-NN sets equal, host
    waits a call and the synchronising calls inside the fold counted
    under ``torch.cuda.set_sync_debug_mode("warn")``; then the sweep's
    shape (a cached reference, a fresh degraded cloud that estimates
    alone);
  * the bucketed 1-NN (``nn_pruned_bucketed_sorted``) a->b and b->a,
    bit-identical to ``nn_pruned_sorted`` when it certifies;
  * calls made the JAX package's way: ``nn_pruned_sorted`` under its
    ``refine_impl`` names ("auto", "pallas", "pallas_interpret", "xla"),
    each launching K1 as "default" does with the same rows, the JAX-style
    positional ``nn_chunked`` and ``synthetic_voxel_pair`` on the card.

It prints:

  * the card's name and power limit (nvidia-smi),
  * each kernel's build time and ptxas resource lines,
  * one line per kernel phase, one timing line per path, with its checks
    (K7 and K1-expanded phases compare valid rows: their fused
    multiply-adds round sentinel rows otherwise); K1, K3 and K4 phases
    give the split count and the blocks launched, and the tier-B phases
    (K1's of the three 800k sweeps, K3's and K4's of the 800k a->a k-NN,
    captured from real searches) run at the automatic split count and at
    one block a tile, K1 and K3 bit-identical to the plain version; every
    K4 phase also runs without its slot skip, with equal member counts and
    sums within MOM_RTOL/MOM_ATOL; the K5 phases give the query rows a
    thread, split, registers and blocks an SM, and the a->b phase times
    each row count K5 is built for,
  * on the estimation path line, each cloud's k-NN with every K3 pass and
    every K4 pass replayed alone, and one profiled cold call (wall,
    device-busy ms, idle share),
  * one ``prologue A/B`` line per pair size and a ``2M stage split`` line,
  * the ``adaptive path`` (with K7's launches by pass), ``payload path``
    and ``float pair under adaptive`` lines, and a ``schedule split`` line
    per pair size (each sweep's time under each schedule with its kernels
    replayed alone),
  * K2a and K2b phases with ``graph_ms`` (their launches captured in one
    CUDA graph, so the wrapper's host time between them does not count);
    K2a with the design the call takes, registers, blocks an SM and shared
    bytes; K2b with its split, ``ms_splits_1``, registers and blocks an SM;
    K1b and K1c phases with ``ms_splits_1``, ``bound_all_pairs_ms``,
    registers and blocks an SM (K1c also its chunks a step),
  * K2c phases with the first design's time (``rounds_ms``) and whether
    the kernel is at or below the stable sort; K3b phases with the time
    without the slot skip and both k-NN kernels' registers and blocks an
    SM,
  * the ``sweep data``, ``sweep path 800k`` (each pair's wall, Mpts/s and
    stages, the stage medians after the first pair, the launch counts),
    ``sweep checks``, ``thin upload 800k`` and ``sharded sweep 800k``
    (each group's wall and Mpts/s) lines,
  * the ``ring path 800k 1-slot`` and ``4-slot`` lines (settled cap, K1
    launches a call, first call, median of RUNS after one warm-up,
    Mpts/s, the largest relative difference from ``pair_stats``), and the
    ``ring brute 60k`` and ``ring normals 60k`` lines,
  * the ``cold fold 800k``, ``bucketed 800k`` and ``api parity`` lines,
  * a ``{"kernels": [...]}`` JSON line (launches on the paths, K1's also
    on the ring's, K1's, K3's and K4's also on the fold's, K1's on the
    bucketed search's runs, error and
    times against the plain version, the bound from this run's shapes and
    data, and for K5, K8 and K2c one PyTorch library call's time), and last
  * ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed check raises, so the exit code is non-zero and the last line is
never printed. Without a CUDA device it exits non-zero before printing any
result. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_POINTS = 800_000
N_BIG = 2_000_000  # the 2M pair of the select-prologue A/B
SMALL_POINTS = 60_000  # pads to 61440 rows: the largest brute-force pair
RUNS = 5
EST_RUNS = 3
COLD_PAIRS = 10  # alternating fold / stepwise pairs on the cold fold line
CAP, FALLBACK, P1 = 32, 256, 8  # the main path's base rung and probe width
K, KCAP, KFT = 30, 64, 256  # the estimation's k and base rung
PLAIN_BUDGET_S = 60.0  # a plain phase predicted slower runs on a subset
# K4 vs plain, float32 summation order: a row of at most K members within
# MOM_RTOL/MOM_ATOL, a row of n > K (a padded query row tied at d == rk with
# thousands of records) within rtol n * 2**-23 (csrc/knn_moments.cu)
MOM_RTOL, MOM_ATOL = 1e-6, 1e-4
D2_TOL, PSNR_TOL = 5e-3, 1e-4  # dB; D2 with estimated normals, the rest
ENGINE_RTOL = 1e-6  # DAG vs fused: the same exact NN terms, summed apart
SWEEP_KW = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
UPLOAD_RUNS = 5  # Cloud.from_numpy calls each, thin and wide, in turns
PER_PAIR_RTOL = 1e-6  # pad="per-pair" vs "common", non-PSNR entries
RING_SLOTS = 4  # the ring's slots on one card, the counterpart of 4 devices
RING_RTOL = 1e-5  # ring stats vs the single-device pair_stats (bench.py's)
RING_RUNS = 3  # timed calls of the brute ring at 60k
NORMALS_Q, NORMALS_DOT = 0.001, 0.999  # |dot| quantile bar of the normals
# Ring normals on rows whose 30-NN set is one whatever the tie order: the
# same neighbours summed in another order (float32 roundings only).
TIE_FREE_DOT = 1.0 - 1e-5
NORMALS_SEEDS = (0, 1, 2)  # bench.make_clouds seeds of the ring normals
KERNELS = {
    "refine_nn": "open_pcc_metric_tpu/ops/refine_pallas.py:575",
    "refine_knn": "open_pcc_metric_tpu/ops/refine_pallas.py:861",
    "knn_moments": "open_pcc_metric_tpu/ops/refine_pallas.py:1330",
    "nn_brute": "open_pcc_metric_tpu/ops/nn_pallas.py:40",
    "select_bbox": "open_pcc_metric_tpu/ops/select_pallas.py:117",
    "count_bbox": "open_pcc_metric_tpu/ops/select_pallas.py:133",
    "adaptive_refine": "open_pcc_metric_tpu/ops/refine_adaptive.py:76",
    "refine_nn_payload": "open_pcc_metric_tpu/ops/refine_pallas.py:1156",
    "select_candidates": "open_pcc_metric_tpu/ops/refine_pallas.py:491",
    "refine_nn_straight": "open_pcc_metric_tpu/ops/refine_pallas.py:77",
    "refine_knn_straight": "open_pcc_metric_tpu/ops/refine_pallas.py:209",
    "refine_nn_fused": "open_pcc_metric_tpu/ops/refine_pallas.py:341",
    # K8 replaces no Pallas kernel: the JAX package's brute k-NN is XLA.
    "knn_brute": "open_pcc_metric_tpu/ops/knn.py (plain XLA)",
    # K9 replaces no Pallas kernel: the JAX package parses PLYs on the host.
    "ply_decode": "open_pcc_metric_tpu/io/loaders.py (host numpy)",
}
# K1c has no caller in either package (grep: refine_nn_pallas_fused is
# defined in refine_pallas.py and called nowhere else; refine_nn_fused is
# called only by this script and the tests), so no path launches it: it
# runs in its phases beside K1b and K1 on the fixed stage-1 tables.
NO_PATH = ("refine_nn_fused",)
SELECT_KERNELS = ("select_bbox", "count_bbox")
PROLOGUE_ENV = ("PCC_NN_PROLOGUE", "PCC_KNN_PROLOGUE")
ADAPTIVE_ENV = {"PCC_REFINE_IMPL": "adaptive"}
PAYLOAD_ENV = {"PCC_PAYLOAD_KERNEL": "1"}
FIXED_ENV = {"PCC_NN_SCHED": "fixed"}
FIXED_KNN_ENV = {"PCC_NN_SCHED": "fixed", "PCC_KNN_SCHED": "fixed"}
# The adaptive schedule's knobs at the base rung (nn_pruned_sorted's map).
ADAPTIVE_CAP, ADAPTIVE_FT3 = max(64, CAP), max(64, FALLBACK // 4)
# The card's published peaks (H100 SXM, NVIDIA's data sheet): float32
# outside the tensor cores, and device memory. A kernel's bound is the
# larger of its operations over the first and its bytes over the second.
PEAK_FP32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
OPS_PER_PAIR = 9  # 3 sub, 3 mul, 2 add and one compare per distance
OPS_PER_PAIR_EXPANDED = 8  # K7, K1 expanded: 1 add, 3 FMA and one compare
# K7 and K1 expanded skip a word only for rows whose best d is below this
# (csrc/pcc_nn.cuh kSkipGuard), where the expanded form cannot round.
SKIP_GUARD = 2.0 ** 22
OPS_PER_MEMBER = 16  # K4: one count and 15 multiply/adds per k-NN member
OPS_PER_BOUND = 17  # a box bound: 6 sub, 6 max, 3 mul, 2 add
OPS_SELECT = OPS_PER_BOUND + 2  # K2a: mask and pack the key
OPS_COUNT = OPS_PER_BOUND + 2  # K2b: compare and add (the mask folds
# into each tile's integer limit, csrc/count_bbox.cu)
OPS_PICK = 1  # K2c: one compare per bound


def _bit_equal(x, y) -> bool:
    import torch

    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return bool(torch.equal(x, y))


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches captured in one
    CUDA graph (after a warm-up call on a side stream), so the host's
    launch overhead between them does not count: the kernel's own time
    where it is shorter than the wrapper's Python."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _once_ms(fn):
    """(result, device ms) of one call, synchronised."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _bound_of(ops, nbytes):
    """(bound_ms, bound_by): the least time the card could take for
    ``ops`` float32 operations and ``nbytes`` bytes, at the published
    peaks."""
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def _bound(ops, tensors_in, tensors_out):
    """``_bound_of`` for reading each input and writing each output once."""
    return _bound_of(ops, sum(x.numel() * x.element_size()
                              for x in (*tensors_in, *tensors_out)
                              if x is not None))


def _refine_bytes(q_points, b_points, perm, cand, tiles, ncand, init, outs,
                  row_bytes=None):
    """Bytes a K1 or K3 call must move, each once: the query rows of its
    tiles, the (x, y, z, id) rows of each distinct chunk in its live slots,
    those slots' ``cand`` entries, ``tiles``, ``ncand``, the seed and the
    outputs. A compacted tier reads a few tiles and chunks of whole clouds,
    which the clouds' sizes would overstate. ``row_bytes``: (query row,
    candidate row) bytes of another layout (K7's packed rows; K6's payload
    row with the candidate)."""
    import torch

    nt, w = cand.shape
    live = (torch.ones_like(cand, dtype=torch.bool) if ncand is None else
            torch.arange(w, device=cand.device)[None, :]
            < ncand.long()[:, None])
    chunks = int(torch.unique(cand[live]).numel())
    n_tiles = nt if tiles is None else int(torch.unique(tiles).numel())
    q_row, b_row = row_bytes or (3 * q_points.element_size(),
                                 3 * b_points.element_size()
                                 + perm.element_size())
    rest = sum(x.numel() * x.element_size()
               for x in (tiles, ncand, *(init or ()), *outs) if x is not None)
    return (256 * (n_tiles * q_row + chunks * b_row)
            + int(live.sum()) * cand.element_size() + rest)


def _live_pairs(cand, ncand):
    """(query, candidate) pairs a refine call visits: 256 x 256 per live
    slot, the slots gated by ``ncand`` when given."""
    import torch

    nt, w = cand.shape
    live = nt * w if ncand is None else int(torch.clamp(ncand, 0, w).sum())
    return live * 256 * 256


def _skip_ops(q_points, b_points, cand, tiles, ncand, thresh, full=None,
              chunk_boxes=None, per_pair=OPS_PER_PAIR):
    """Operations K1, K3, K3b, K4, K6 and K7 must do on this data, for their
    bound. A warp skips a word (32 staged records) when every row's bound
    to the word's box is above the row's threshold at that point, which
    never falls below its final one, ``thresh`` (K1, K6: the row's d; K7:
    its d below the skip guard, else inf; K3 and K4: its k-th d, final on
    K4's entry). So they do, at least, a point-box bound (OPS_PER_BOUND)
    for each row and live word, and ``per_pair`` operations for each pair
    of a (warp, word) where some row is bounded at or below ``thresh``. ``full``: a tile mask
    whose live pairs K3 also walks once without skipping (its threshold
    pass). ``chunk_boxes`` (K3b's and K4's slot skip): each row bounds each
    slot's
    chunk box instead, and only the slots some row of the tile is bounded
    at or below ``thresh`` from cost their word bounds."""
    import torch

    nt, w = cand.shape
    dev = cand.device
    t = torch.arange(nt, device=dev) if tiles is None else tiles.long()
    live = (torch.full((nt,), w, device=dev) if ncand is None
            else torch.clamp(ncand.long(), 0, w))
    words = b_points.reshape(-1, 8, 32, 3)
    lo, hi = words.amin(2), words.amax(2)
    q = q_points.reshape(-1, 256, 3)
    th = thresh.reshape(nt, 256)
    step = max(1, 4096 // w)
    near_words = 0
    bounded_slots = int(live.sum())  # slots whose 8 word boxes are bounded
    for i in range(0, nt, step):
        qq = q[t[i:i + step]][:, None, None]
        c = cand[i:i + step].long()
        gap = torch.clamp(torch.maximum(qq - hi[c][..., None, :],
                                        lo[c][..., None, :] - qq), min=0)
        sq = gap * gap
        lb = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # (n, w, word, row)
        near = (lb <= th[i:i + step, None, None, :]).reshape(
            *lb.shape[:3], 8, 32).any(-1)
        on = torch.arange(w, device=dev)[None, :] < live[i:i + step, None]
        near_words += int((near & on[:, :, None, None]).sum())
        if chunk_boxes is not None:
            qc = q[t[i:i + step]][:, None]
            gap = torch.clamp(torch.maximum(qc - chunk_boxes[1][c][:, :, None],
                                            chunk_boxes[0][c][:, :, None]
                                            - qc), min=0)
            sq = gap * gap
            clb = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # (n, w, row)
            needed = (clb <= th[i:i + step, None, :]).any(-1) & on
            bounded_slots -= int((on & ~needed).sum())
    ops = (per_pair * near_words * 32 * 32
           + OPS_PER_BOUND * bounded_slots * 8 * 256)
    if chunk_boxes is not None:
        ops += OPS_PER_BOUND * int(live.sum()) * 256
    if full is not None:
        ops += OPS_PER_PAIR * int(live[full].sum()) * 256 * 256
    return ops


def _count_ops(a_lo, a_hi, b_lo, b_hi, thr):
    """Operations K2b must do on this data, for its bound: a box bound and
    a compare for each tile and group of 32 consecutive chunks, and
    OPS_COUNT for each chunk of the groups whose box's rounded bound is
    within the tile's inflated threshold (the group skip cannot avoid
    them; csrc/count_bbox.cu)."""
    import torch

    from open_pcc_metric_tpu_torch.ops.grid import bbox_lower_bounds
    from open_pcc_metric_tpu_torch.ops.select import inflate, mask_lb, pad128

    ncb = b_lo.shape[0]
    starts = torch.arange(0, ncb, 32, device=b_lo.device)
    member = torch.clamp(starts[:, None] + torch.arange(32, device=b_lo.device),
                         max=ncb - 1)  # a short last group repeats its last
    lo, hi = b_lo[member].amin(1), b_hi[member].amax(1)
    near = (mask_lb(bbox_lower_bounds(a_lo, a_hi, lo, hi), pad128(ncb))
            <= inflate(thr, ncb)[:, None])
    sizes = torch.clamp(ncb - starts, max=32).float()
    return ((OPS_PER_BOUND + 1) * near.numel()
            + OPS_COUNT * float((near.float() @ sizes).sum()))


def _counts_of(dist, lb, valid_t):
    """Certificate counts: chunks with lb <= the tile's padded ub, where ub
    is the largest ``dist`` over the tile's valid rows."""
    import torch

    eps = torch.finfo(torch.float32).eps
    ub = torch.where(valid_t, dist, -torch.inf).amax(dim=1)
    ub_eff = ub * (1 + 8 * eps) + 8 * eps
    return (lb <= ub_eff[:, None]).sum(dim=1, dtype=torch.int32)


def kernel_phases(a, b, float_cloud):
    """K1 against refine_nn_reference on the card, at main-path shapes.

    Returns one record per phase: the call's shape, the largest |d| error
    (0 when bit-identical, which is required), and both times.
    """
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import stable_top, tile_bounds
    from open_pcc_metric_tpu_torch.ops.refine import (
        refine_nn, refine_nn_reference, sm_count, split_count)

    def check(name, qg, bg, cand, **kw):
        args = (qg.points, bg.points, bg.perm, cand.contiguous())
        dk, ik = refine_nn(*args, **kw)
        torch.cuda.synchronize()
        dr, ir = refine_nn_reference(*args, **kw)
        torch.cuda.synchronize()
        finite = torch.isfinite(dr)
        err = float(torch.where(finite, (dk - dr).abs(), 0).max())
        if not (_bit_equal(dk, dr) and _bit_equal(ik, ir)):
            bad = int(((dk != dr) | (ik != ir)).sum())
            raise AssertionError(
                f"K1 phase {name}: {bad} rows differ from refine_nn_reference "
                f"(max |d| error {err})")
        bound_ms, bound_by = _bound_of(
            _skip_ops(qg.points, bg.points, args[3], kw.get("tiles"),
                      kw.get("ncand"), dk),
            _refine_bytes(*args, kw.get("tiles"), kw.get("ncand"),
                          kw.get("init"), (dk, ik)))
        splits = split_count(*cand.shape, sm_count(cand.device))
        rec = {
            "phase": name, "tiles": int(cand.shape[0]),
            "slots": int(cand.shape[1]), "splits": splits,
            "blocks": int(cand.shape[0]) * splits, "max_abs_err": err,
            "ms": _time_ms(lambda: refine_nn(*args, **kw), 20),
            "plain_ms": _time_ms(lambda: refine_nn_reference(*args, **kw), 3),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("kernel phase " + json.dumps(rec), flush=True)
        return dk, ik, rec

    records = []
    ga, gb = a.get_grid(), b.get_grid()
    valid_t, lb, order = tile_bounds(ga, gb, a.n)
    # Probe: the p1 lowest-lb chunks of every tile.
    d1, i1, rec = check("probe a->b", ga, gb, order[:, :P1])
    records.append(rec)
    # Gated, seeded in-place extension to min(count, cap).
    ncand2 = torch.clamp(_counts_of(d1, lb, valid_t) - P1, 0, CAP - P1).int()
    d2, i2, rec = check("extension a->b", ga, gb, order[:, P1:CAP],
                        ncand=ncand2, init=(d1, i1))
    records.append(rec)
    # Compacted tier-A tiles, read in place through global tile ids.
    counts = _counts_of(d2, lb, valid_t)
    otiles = stable_top(counts, FALLBACK)
    cap2a = min(4 * CAP, gb.n_chunks)
    oc = counts[otiles]
    ncand_a = torch.where(oc > CAP, torch.clamp(oc, max=cap2a) - CAP, 0).int()
    init_a = (d2[otiles].contiguous(), i2[otiles].contiguous())
    records.append(check("tier A a->b (gated)", ga, gb, order[otiles, CAP:cap2a],
                         tiles=otiles.int(), ncand=ncand_a, init=init_a)[2])
    records.append(check("tier A a->b (all slots)", ga, gb,
                         order[otiles, CAP:cap2a], tiles=otiles.int(),
                         init=init_a)[2])
    # Self search: exclude_self on the full probe and on compacted tiles
    # whose candidate rows include the tile's own chunk.
    order_s = tile_bounds(ga, ga, a.n)[2]
    records.append(check("self probe a->a", ga, ga, order_s[:, :P1],
                         exclude_self=True)[2])
    records.append(check("self tier a->a (compacted)", ga, ga,
                         order_s[otiles, :cap2a - CAP], tiles=otiles.int(),
                         exclude_self=True)[2])
    # A float cloud: every distance is a rounded float, not an integer.
    gf = float_cloud.get_grid()
    valid_f, lb_f, order_f = tile_bounds(gf, gb, float_cloud.n)
    df, i_f, rec = check("float probe", gf, gb, order_f[:, :P1])
    records.append(rec)
    ncand_f = torch.clamp(_counts_of(df, lb_f, valid_f) - P1, 0, CAP - P1).int()
    records.append(check("float extension", gf, gb, order_f[:, P1:CAP],
                         ncand=ncand_f, init=(df, i_f))[2])
    return records


def adaptive_phases(a, b):
    """K7 against adaptive_refine_reference on the card, at the shapes the
    adaptive a->b sweep of the 800k pair gives it at the base rung (cap
    ADAPTIVE_CAP, ft3 ADAPTIVE_FT3, p1 P1): the P1 probe, the seeded gated
    P2, P3 at the schedule's shape (the tail tiles' lb order beyond cap,
    seeded with P2's rows), P3 as the first design's schedule called it
    (from scratch over the full lb order, so the kernel's gain and the
    schedule's show apart), and a self probe with exclude_self. Each runs
    at the automatic split and at ``splits=1``; d and id must be
    bit-identical on valid rows (the kernel fuses the multiply-adds the
    plain version rounds one by one, which only sentinel rows can tell
    apart), and the two P3 calls' valid rows equal. Bound: the operations
    the guarded word skip cannot avoid (``_skip_ops`` against each row's
    final d where it is below SKIP_GUARD, else no skip) and the bytes of
    the packed rows the call reads (``_refine_bytes``); the all-pairs bound
    beside it. The probe's cand also goes through K1 and K1's expanded
    mode: equal on valid rows, times side by side. Returns (K7 records,
    the K1-expanded record)."""
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        cert_ub, count_under, stable_top, tile_bounds)
    from open_pcc_metric_tpu_torch.ops.refine import (
        occupancy, refine_nn, refine_nn_reference, sm_count, split_count)
    from open_pcc_metric_tpu_torch.ops.refine_adaptive import (
        adaptive_refine, adaptive_refine_reference, pack_candidates,
        pack_queries)

    dev = a.points.device
    regs, per_sm = occupancy("adaptive_refine")

    def valid_rows(tids):
        return (tids.long()[:, None] * 256
                + torch.arange(256, device=dev)) < a.n

    def same(name, got, want, valid):
        if not all(_bit_equal(x[valid], y[valid]) for x, y in zip(got, want)):
            bad = int(((got[0] != want[0]) | (got[1] != want[1]))[valid].sum())
            raise AssertionError(f"{name}: {bad} valid rows differ")

    def check(name, qg, bg, cand, ncand, tids, **kw):
        bhat = pack_candidates(bg.points, bg.perm)
        args = (qhat, bhat, cand.contiguous(), ncand.to(torch.int32),
                tids.to(torch.int32))
        got = adaptive_refine(*args, **kw)
        one = adaptive_refine(*args, splits=1, **kw)
        torch.cuda.synchronize()
        want, plain_ms = _once_ms(lambda: adaptive_refine_reference(*args,
                                                                    **kw))
        valid = valid_rows(args[4])
        same(f"K7 phase {name}", got, want, valid)
        same(f"K7 phase {name} at splits=1", one, want, valid)
        rows, w = args[2].shape
        nbytes = _refine_bytes(qg.points, bg.points, bg.perm, args[2],
                               args[4], args[3], kw.get("init"), got,
                               row_bytes=(16, 20))
        thresh = torch.where(got[0] < SKIP_GUARD, got[0], torch.inf)
        bound_ms, bound_by = _bound_of(
            _skip_ops(qg.points, bg.points, args[2], args[4], args[3],
                      thresh, per_pair=OPS_PER_PAIR_EXPANDED), nbytes)
        splits = split_count(rows, w, sm_count(dev))
        live = torch.clamp(args[3], 0, w)
        rec = {
            "phase": name, "rows": int(rows), "slots": int(w),
            "live_slots": int(live.sum()), "max_live_slots": int(live.max()),
            "splits": splits, "blocks": int(rows) * splits,
            "rows_at_or_above_guard": int(
                (~(got[0] < SKIP_GUARD) & valid & (live > 0)[:, None]).sum()),
            "compared": "valid rows, at the automatic split and at splits=1",
            "max_abs_err": 0.0,
            "ms": _time_ms(lambda: adaptive_refine(*args, **kw), 20),
            "ms_splits_1": _time_ms(
                lambda: adaptive_refine(*args, splits=1, **kw), 20),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_all_pairs_ms": _bound_of(
                OPS_PER_PAIR_EXPANDED * _live_pairs(args[2], args[3]),
                nbytes)[0],
            "library_ms": None, "registers": regs, "blocks_per_sm": per_sm,
        }
        return got, rec

    def show(rec):
        print("kernel phase K7 " + json.dumps(rec), flush=True)
        recs.append(rec)

    ga, gb = a.get_grid(), b.get_grid()
    valid_t, lb, order = tile_bounds(ga, gb, a.n)
    nta = order.shape[0]
    cap = min(ADAPTIVE_CAP, gb.n_chunks)
    qhat = pack_queries(ga.points)
    tids = torch.arange(nta, dtype=torch.int32, device=dev)
    full = torch.full((nta,), P1, dtype=torch.int32, device=dev)
    recs = []
    (d1, i1), rec = check("P1 probe a->b", ga, gb, order[:, :P1], full, tids)
    # The same cand through K1 (difference form) and K1's expanded mode.
    args = (ga.points, gb.points, gb.perm, order[:, :P1].contiguous())
    k1 = refine_nn(*args)
    k1x = refine_nn(*args, expanded=True)
    torch.cuda.synchronize()
    k1x_want, k1x_plain_ms = _once_ms(
        lambda: refine_nn_reference(*args, expanded=True))
    same("K1 expanded probe a->b", k1x, k1x_want, valid_t)
    same("K1 expanded vs K1", k1x, k1, valid_t)
    same("K7 probe vs K1", (d1, i1), k1, valid_t)
    rec["k1_ms"] = _time_ms(lambda: refine_nn(*args), 20)
    rec["k1_expanded_ms"] = _time_ms(lambda: refine_nn(*args, expanded=True),
                                     20)
    show(rec)
    thresh = torch.where(k1x[0] < SKIP_GUARD, k1x[0], torch.inf)
    nbytes = _refine_bytes(*args, None, None, None, k1x)
    bound_ms, bound_by = _bound_of(
        _skip_ops(ga.points, gb.points, args[3], None, None, thresh,
                  per_pair=OPS_PER_PAIR_EXPANDED), nbytes)
    k1x_rec = {
        "phase": "K1 expanded probe a->b", "tiles": nta, "slots": P1,
        "compared": "valid rows (also equal to K1 and K7)", "max_abs_err": 0.0,
        "ms": rec["k1_expanded_ms"], "plain_ms": k1x_plain_ms,
        "k1_ms": rec["k1_ms"], "k7_ms": rec["ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_all_pairs_ms": _bound_of(
            OPS_PER_PAIR_EXPANDED * _live_pairs(args[3], None), nbytes)[0],
        "library_ms": None,
    }
    print("kernel phase K1 expanded " + json.dumps(k1x_rec), flush=True)

    count1 = count_under(lb, cert_ub(d1, valid_t))
    ncand2 = torch.clamp(torch.clamp(count1, max=cap) - P1, 0, cap - P1)
    (d2, i2), rec = check("P2 extension a->b (seeded, gated)", ga, gb,
                          order[:, P1:cap], ncand2, tids, init=(d1, i1))
    show(rec)
    count2 = count_under(lb, cert_ub(d2, valid_t))
    is_tail = count2 > cap
    otiles = stable_top(torch.where(is_tail, count2, 0), min(ADAPTIVE_FT3,
                                                              nta))
    ncand3 = torch.where(is_tail[otiles], count2[otiles] - cap, 0)
    seeded, rec = check("P3 tail a->b (seeded beyond cap)", ga, gb,
                        order[otiles, cap:], ncand3, otiles,
                        init=(d2[otiles].contiguous(),
                              i2[otiles].contiguous()))
    rec["tail_tiles"] = int(is_tail.sum())
    rec["tail_slots_beyond_cap"] = sorted(
        (int(x) for x in ncand3[ncand3 > 0]), reverse=True)
    show(rec)
    ncand3_full = torch.where(is_tail[otiles], count2[otiles], 0)
    scratch, rec = check("P3 tail a->b (from scratch, full lb order)", ga, gb,
                         order[otiles], ncand3_full, otiles)
    take = (ncand3_full > 0)[:, None] & valid_rows(otiles)
    same("K7 P3 seeded vs from scratch", seeded, scratch, take)
    rec["equals_seeded_on_tail_rows"] = True
    show(rec)
    order_s = tile_bounds(ga, ga, a.n)[2]
    _, rec = check("self probe a->a", ga, ga, order_s[:, :P1], full, tids,
                   exclude_self=True)
    show(rec)
    return recs, k1x_rec


def payload_phases(origin, reconst, dev):
    """K6 against refine_nn_payload_reference on the card at the payload
    schedule's stage 1 on the 800k pair (cap CAP, no gate, no seed): a->b
    (3328 x 32) and b->a (1920 x 32), with the search cloud's points,
    colours and normals as payload. d, id and payload must be
    bit-identical on every row (K6 uses the difference form), and the
    payload equal to a gather of the original-order rows at the id.
    Bound: the operations the word skip cannot avoid (``_skip_ops``
    against each row's final d), the bytes the call reads
    (``_refine_bytes``) plus one payload row read a query; the all-pairs
    bound beside it."""
    import torch

    from open_pcc_metric_tpu_torch.ops.fused import _pack_payload
    from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_bounds
    from open_pcc_metric_tpu_torch.ops.refine import (
        occupancy, refine_nn_payload, refine_nn_payload_reference)

    regs, per_sm = occupancy("refine_nn_payload")
    a, b = _pair_clouds(origin, reconst, dev)
    recs = []
    for name, q, s in (("a->b", a, b), ("b->a", b, a)):
        gq, gs = q.get_grid(), s.get_grid()
        order = tile_bounds(gq, gs, q.n)[2]
        cand = order[:, :min(CAP, gs.n_chunks)].contiguous()
        pay_o = _pack_payload(s.points, s.colors, s.normals)
        args = (gq.points, gs.points, gs.perm, pay_o[gs.perm.long()], cand)
        got = refine_nn_payload(*args)
        torch.cuda.synchronize()
        want, plain_ms = _once_ms(lambda: refine_nn_payload_reference(*args))
        if not all(_bit_equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"K6 phase {name}: differs from "
                                 "refine_nn_payload_reference")
        if not _bit_equal(got[2], pay_o[got[1].reshape(-1).long()]):
            raise AssertionError(f"K6 phase {name}: the payload is not the "
                                 "gather at the id")
        nbytes = (_refine_bytes(gq.points, gs.points, gs.perm, cand, None,
                                None, None, got)
                  + got[2].numel() * got[2].element_size())
        bound_ms, bound_by = _bound_of(
            _skip_ops(gq.points, gs.points, cand, None, None, got[0]),
            nbytes)
        rec = {
            "phase": f"stage 1 {name}", "tiles": int(cand.shape[0]),
            "slots": int(cand.shape[1]), "compared": "every row",
            "max_abs_err": 0.0,
            "ms": _time_ms(lambda: refine_nn_payload(*args), 20),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_all_pairs_ms": _bound_of(
                OPS_PER_PAIR * _live_pairs(cand, None), nbytes)[0],
            "library_ms": None, "registers": regs, "blocks_per_sm": per_sm,
        }
        print("kernel phase K6 " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def knn_phases(a, float_cloud):
    """K3 and K4 against their plain versions on the card, at the shapes the
    estimation of cloud ``a`` gives them (self 30-NN, cap 64, fallback 256,
    p1 8): the probe, the gated seeded extension, tier A on compacted
    tiles, K4 stage 1, a K4 tier, and one float-cloud probe.

    K3 must be bit-identical in d and id. K4 (``moments_phase``) must
    count the same members (exactly k on every valid row once the tier has
    run) and agree on the other sums within MOM_RTOL/MOM_ATOL. A plain K3
    call predicted to pass PLAIN_BUDGET_S runs on a stated subset of tiles
    that holds the 64 with the most live slots. Returns (K3 records, K4
    records).
    """
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import stable_top, tile_bounds
    from open_pcc_metric_tpu_torch.ops.refine import (
        refine_knn, refine_knn_reference, sm_count, split_count)

    dev = a.points.device

    def subset(live, nt, n_sub):
        """At least n_sub tile rows: the 64 with the most live slots and
        n_sub evenly spaced ones (all rows when nt <= n_sub)."""
        if nt <= n_sub:
            return torch.arange(nt, device=dev)
        keep = torch.zeros(nt, dtype=torch.bool, device=dev)
        keep[stable_top(live, 64)] = True
        keep[torch.linspace(0, nt - 1, n_sub, device=dev).long()] = True
        return keep.nonzero()[:, 0]

    def run(name, kernel, plain, compare, cand, ncand=None, tiles=None,
            init=None, grid=None, **kw):
        """Kernel on the full call, plain on the full call or a subset,
        over ``grid`` (cloud a's by default). The bound counts K3's
        unskippable operations (``_skip_ops``) and the bytes it reads."""
        grid = grid or g
        nt = cand.shape[0]
        args = dict(kw, tiles=tiles, init=init)
        if ncand is not None:
            args["ncand"] = ncand
        out = kernel(cand=cand, **args)
        torch.cuda.synchronize()
        rows = torch.arange(nt, device=dev)
        live = ncand if ncand is not None else torch.full(
            (nt,), cand.shape[1], dtype=torch.int32, device=dev)
        sub_rows = subset(live, nt, 512)
        sub, sub_ms = _once_ms(lambda: plain(cand=cand[sub_rows].contiguous(),
                                             **_rows_of(args, sub_rows)))
        predicted_s = sub_ms / len(sub_rows) * nt / 1e3
        note = None
        if len(sub_rows) == nt:
            want, plain_ms = sub, sub_ms
        elif predicted_s > PLAIN_BUDGET_S:
            rows, want, plain_ms = sub_rows, sub, None
            note = (f"plain version compared on {len(rows)} of {nt} tiles "
                    "(the 64 with the most live slots and 512 evenly "
                    f"spaced): the full call was predicted to take "
                    f"{predicted_s:.0f} s")
        else:
            want, plain_ms = _once_ms(lambda: plain(cand=cand, **args))
        got = tuple(x[rows] for x in out)
        err = compare(name, got, want)
        # the threshold pass when a buffer starts open
        full = (torch.ones(nt, dtype=torch.bool, device=dev)
                if init is None else torch.isinf(init[0][..., -1]).any(1))
        bound_ms, bound_by = _bound_of(
            _skip_ops(grid.points, grid.points, cand, tiles, ncand,
                      out[0][..., -1], full),
            _refine_bytes(grid.points, grid.points, grid.perm, cand,
                          tiles, ncand, init, out))
        rec = {
            "phase": name, "tiles": int(nt), "slots": int(cand.shape[1]),
            "max_abs_err": err,
            "ms": _time_ms(lambda: kernel(cand=cand, **args), 5),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rec["splits"] = split_count(nt, int(cand.shape[1]), sm_count(dev))
        rec["blocks"] = int(nt) * rec["splits"]
        if note:
            rec["plain_subset"] = note
            rec["plain_subset_ms"] = sub_ms
        print("kernel phase " + json.dumps(rec), flush=True)
        return out, rec

    def knn_compare(name, got, want):
        if not (_bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1])):
            bad = int(((got[0] != want[0]) | (got[1] != want[1])).sum())
            raise AssertionError(
                f"K3 phase {name}: {bad} entries differ from "
                "refine_knn_reference")
        return 0.0

    g = a.get_grid()
    valid_t, lb, order = tile_bounds(g, g, a.n)
    ncb = g.n_chunks

    def k3(cand, **kw):
        return refine_knn(g.points, g.points, g.perm, cand.contiguous(), K, **kw)

    def k3_plain(cand, **kw):
        return refine_knn_reference(g.points, g.points, g.perm,
                                    cand.contiguous(), K, **kw)

    k3_recs, k4_recs = [], []
    (d1, i1), rec = run("knn probe a->a", k3, k3_plain, knn_compare,
                        order[:, :P1])
    k3_recs.append(rec)
    counts1 = _counts_of(d1[:, :, -1], lb, valid_t)
    ncand2 = torch.clamp(counts1 - P1, 0, KCAP - P1).int()
    (dk, ik), rec = run("knn extension a->a (gated, seeded)", k3, k3_plain,
                        knn_compare, order[:, P1:KCAP], ncand=ncand2,
                        init=(d1, i1))
    k3_recs.append(rec)
    counts = _counts_of(dk[:, :, -1], lb, valid_t)
    otiles = stable_top(counts, KFT)
    cap2a = min(max(2 * KCAP, 128), ncb)
    oc = counts[otiles]
    ncand_a = torch.where(oc > KCAP, torch.clamp(oc, max=cap2a) - KCAP, 0).int()
    (fd, fi), rec = run("knn tier A a->a (compacted)", k3, k3_plain,
                        knn_compare, order[otiles, KCAP:cap2a],
                        ncand=ncand_a, tiles=otiles.int(),
                        init=(dk[otiles].contiguous(), ik[otiles].contiguous()))
    k3_recs.append(rec)
    dk = dk.index_copy(0, otiles, fd)
    ik = ik.index_copy(0, otiles, fi)

    rk, rid = dk[:, :, -1].contiguous(), ik[:, :, -1].contiguous()
    countsf = _counts_of(rk, lb, valid_t)
    boxes = (g.bbox_lo, g.bbox_hi)
    mom, rec = moments_phase("moments stage 1 a->a", (
        g.points, g.points, g.perm, order[:, :KCAP].contiguous(),
        torch.clamp(countsf, max=KCAP).int(), rk, rid), dict(boxes=boxes))
    k4_recs.append(rec)
    cf = countsf[otiles]
    ncm = torch.where(cf > KCAP, torch.clamp(cf, max=cap2a) - KCAP, 0).int()
    part, rec = moments_phase("moments tier A a->a (compacted)", (
        g.points, g.points, g.perm, order[otiles, KCAP:cap2a].contiguous(),
        ncm, rk[otiles].contiguous(), rid[otiles].contiguous()),
        dict(tiles=otiles.int(), init=mom[otiles].contiguous(), boxes=boxes))
    k4_recs.append(rec)
    mom = mom.index_copy(0, otiles, part)
    # Every valid row whose tile the two passes cover counts exactly k.
    in_tier = torch.zeros_like(countsf, dtype=torch.bool)
    in_tier[otiles] = True
    covered = ((countsf <= KCAP) | (in_tier & (countsf <= cap2a)))[:, None] \
        & valid_t
    uncovered = int((valid_t & ~covered).sum())
    cnt = mom[..., 0][covered]
    if not bool((cnt == K).all()):
        raise AssertionError(f"K4: {int((cnt != K).sum())} valid rows do not "
                             f"count exactly {K} members")
    print(f"moments: {int(covered.sum())} valid rows count exactly {K} "
          f"members ({uncovered} rows left to tier B)", flush=True)

    gf = float_cloud.get_grid()
    order_f = tile_bounds(gf, gf, float_cloud.n)[2]

    def k3f(cand, **kw):
        return refine_knn(gf.points, gf.points, gf.perm, cand.contiguous(), K,
                          **kw)

    def k3f_plain(cand, **kw):
        return refine_knn_reference(gf.points, gf.points, gf.perm,
                                    cand.contiguous(), K, **kw)

    k3_recs.append(run("knn float probe", k3f, k3f_plain, knn_compare,
                       order_f[:, :P1], grid=gf)[1])
    return k3_recs, k4_recs


def _mom_err(label, got, want):
    """Largest |sum| error of K4 against the plain version; raises unless
    the member counts are equal and every row's sums are within MOM_ATOL +
    rtol |want|, rtol MOM_RTOL on a row of at most K members and n * 2**-23
    on a row of n > K."""
    import torch

    if not torch.equal(got[..., 0], want[..., 0]):
        bad = int((got[..., 0] != want[..., 0]).sum())
        raise AssertionError(f"{label}: {bad} member counts differ from "
                             "knn_moments_reference")
    cnt = want[..., :1]
    rtol = torch.where(cnt <= K, torch.full_like(cnt, MOM_RTOL),
                       cnt * 2.0 ** -23)
    err = (got - want).abs()
    if not bool((err <= MOM_ATOL + rtol * want.abs()).all()):
        raise AssertionError(f"{label}: sums off by up to {float(err.max())}")
    return float(err.max())


def moments_phase(label, args, kw):
    """K4 on one call, ``args`` = (q, b, perm, cand, ncand, rk, ik) and
    ``kw`` (tiles, init, boxes) as knn_pruned_sorted makes it, against
    knn_moments_reference on the card: at the automatic split and at
    ``splits=1``, each with member counts equal and sums within the
    tolerance of ``_mom_err``.
    Bound: the operations the word and slot skips cannot avoid against the
    final rk (``_skip_ops``) plus OPS_PER_MEMBER a member, and the bytes the
    call reads (``_refine_bytes``, with rk and ik); the all-pairs bound of
    the first design's records beside it. Returns (the automatic split's
    output, the record)."""
    import torch

    from open_pcc_metric_tpu_torch.ops.refine import (
        knn_moments, knn_moments_reference, occupancy, sm_count, split_count)

    q, b, perm, cand, ncand, rk, ik = args
    tiles, init, boxes = kw.get("tiles"), kw.get("init"), kw.get("boxes")
    variants = {"auto": {}, "splits=1": {"splits": 1}}
    got = {v: knn_moments(*args, **dict(kw, **x)) for v, x in variants.items()}
    torch.cuda.synchronize()
    plain_kw = {k: v for k, v in kw.items() if k != "boxes"}
    want, plain_ms = _once_ms(lambda: knn_moments_reference(*args, **plain_kw))
    err = max(_mom_err(f"K4 phase {label} ({v})", out, want)
              for v, out in got.items())
    members = float(got["auto"][..., 0].sum()) - (
        0.0 if init is None else float(init[..., 0].sum()))
    nbytes = _refine_bytes(q, b, perm, cand, tiles, ncand,
                           None if init is None else (init,),
                           (got["auto"], rk, ik))
    bound_ms, bound_by = _bound_of(
        _skip_ops(q, b, cand, tiles, ncand, rk, chunk_boxes=boxes)
        + OPS_PER_MEMBER * members, nbytes)
    nt, w = cand.shape
    splits = split_count(nt, w, sm_count(cand.device))
    live = torch.clamp(ncand, 0, w)
    regs, per_sm = occupancy("knn_moments")
    rec = {
        "phase": label, "tiles": int(nt), "slots": int(w),
        "live_slots": int(live.sum()), "max_live_slots": int(live.max()),
        "splits": splits, "blocks": int(nt) * splits, "max_abs_err": err,
        "compared": "every row, at the automatic split and at splits=1",
        "ms": _time_ms(lambda: knn_moments(*args, **kw), 10),
        "ms_splits_1": _time_ms(lambda: knn_moments(*args, splits=1, **kw),
                                10),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_all_pairs_ms": _bound_of(
            OPS_PER_PAIR * _live_pairs(cand, ncand)
            + OPS_PER_MEMBER * members, nbytes)[0],
        "library_ms": None, "registers": regs, "blocks_per_sm": per_sm,
    }
    print("kernel phase K4 " + json.dumps(rec), flush=True)
    return got["auto"], rec


def tail_phases(a, b):
    """The tier-B calls of real 800k searches at the base rungs, against
    their plain versions on the card: K1's of the a->b, b->a and self
    sweeps (cap CAP, fallback FALLBACK), and K3's and K4's of the a->a
    estimation k-NN with moments (k K, cap KCAP, fallback KFT), captured as
    the schedules make them. Each runs at the automatic split count and at
    one block a tile (``splits=1``) in this run; K1 and K3 must be
    bit-identical to the plain version in d and id, K4 as
    ``moments_phase`` says. Returns (K1, K3, K4 records)."""
    import torch

    from open_pcc_metric_tpu_torch.ops import knn_pruned, nn_pruned
    from open_pcc_metric_tpu_torch.ops.refine import (
        refine_knn, refine_knn_reference, refine_nn, refine_nn_reference)

    def phase(label, kernel, plain, call):
        args, kw = call
        cand, ncand = args[3], kw["ncand"]
        knn = kernel is refine_knn
        nt, w = cand.shape
        splits, blocks = _split_of(call)
        got = {"auto": kernel(*args, **kw), "1": kernel(*args, splits=1, **kw)}
        torch.cuda.synchronize()
        want, plain_ms = _once_ms(lambda: plain(*args, **kw))
        for s, out in got.items():
            if not all(_bit_equal(x, y) for x, y in zip(out, want)):
                bad = int(((out[0] != want[0]) | (out[1] != want[1])).sum())
                raise AssertionError(f"{label} at splits={s}: {bad} entries "
                                     "differ from the plain version")
        live = torch.clamp(ncand, 0, w)
        seed_d = kw["init"][0]
        ops = _skip_ops(args[0], args[1], cand, kw.get("tiles"), ncand,
                        want[0][..., -1] if knn else want[0],
                        torch.isinf(seed_d[..., -1]).any(1) if knn else None)
        bound_ms, bound_by = _bound_of(
            ops, _refine_bytes(*args[:4], kw.get("tiles"), ncand, kw["init"],
                               want))
        rec = {
            "phase": label, "tiles": int(nt), "slots": int(w),
            "live_slots": int(live.sum()), "max_live_slots": int(live.max()),
            "splits": splits, "blocks": blocks, "max_abs_err": 0.0,
            "compared": "every row, at the automatic split and at splits=1",
            "ms": _time_ms(lambda: kernel(*args, **kw), 10),
            "ms_splits_1": _time_ms(lambda: kernel(*args, splits=1, **kw), 10),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        print("kernel phase " + json.dumps(rec), flush=True)
        return rec

    ga, gb = a.get_grid(), b.get_grid()
    k1 = []
    for name, gq, gs, nq, ex in (("a->b", ga, gb, a.n, False),
                                 ("b->a", gb, ga, b.n, False),
                                 ("self a->a", ga, ga, a.n, True)):
        calls = _passes(_calls(["refine_nn"], lambda: nn_pruned.nn_pruned_sorted(
            gq, gs, nq, exclude_self=ex, cap=CAP,
            fallback_tiles=FALLBACK))["refine_nn"])
        if "tier B" not in calls:
            raise AssertionError(f"the 800k {name} sweep ran no tier B")
        k1.append(phase(f"tier B {name}", refine_nn, refine_nn_reference,
                        calls["tier B"]))
    calls = _calls(["refine_knn", "knn_moments"],
                   lambda: knn_pruned.knn_pruned_sorted(
                       ga, ga, a.n, K, cap=KCAP, fallback_tiles=KFT,
                       with_moments=True), knn_pruned)
    k3_calls = _passes(calls["refine_knn"])
    if "tier B" not in k3_calls:
        raise AssertionError("the 800k a->a k-NN ran no tier B")
    k3 = [phase("knn tier B a->a", refine_knn, refine_knn_reference,
                k3_calls["tier B"])]
    k4_calls = dict(zip(MOMENT_PASSES, calls["knn_moments"]))
    if len(calls["knn_moments"]) != len(MOMENT_PASSES):
        raise AssertionError(f"{len(calls['knn_moments'])} K4 calls in the "
                             "800k a->a k-NN, not one a pass")
    k4 = [moments_phase("moments tier B a->a", *k4_calls["tier B"])[1]]
    return k1, k3, k4


def estimation_split(clouds, smi):
    """Each cloud's 30-NN of the estimation (counted schedule, base rung
    KCAP, KFT, with moments): its stream time, each K3 pass replayed alone
    (with its split count) and K4's launches replayed alone, together and
    by pass (with their split counts). CUDA events, mean of 5."""
    from open_pcc_metric_tpu_torch.ops import knn_pruned

    out = {}
    for name, c in clouds:
        g = c.get_grid()

        def knn():
            return knn_pruned.knn_pruned_sorted(
                g, g, c.n, K, cap=KCAP, fallback_tiles=KFT, with_moments=True)

        calls = _calls(["refine_knn", "knn_moments"], knn, knn_pruned)
        real = {n: getattr(knn_pruned, n) for n in calls}
        total = _time_ms(knn, 5)
        k3 = {p: _time_ms(lambda x=x, kw=kw: real["refine_knn"](*x, **kw), 5)
              for p, (x, kw) in _passes(calls["refine_knn"]).items()}
        k4 = _time_ms(lambda: [real["knn_moments"](*x, **kw)
                               for x, kw in calls["knn_moments"]], 5)
        k4_calls = dict(zip(MOMENT_PASSES, calls["knn_moments"]))
        out[name] = {"knn_ms": total, "k3_ms": k3,
                     "k3_splits": {p: _split_of(call)[0] for p, call in
                                   _passes(calls["refine_knn"]).items()},
                     "k4_ms": k4,
                     "k4_passes_ms": {
                         p: _time_ms(lambda x=x, kw=kw: real["knn_moments"](
                             *x, **kw), 5) for p, (x, kw) in k4_calls.items()},
                     "k4_splits": {p: _split_of(call)[0]
                                   for p, call in k4_calls.items()},
                     "rest_ms": total - sum(k3.values()) - k4}
    return {"rung": [KCAP, KFT], "clouds": out, "card": smi}


def cold_profile(origin, reconst, dev):
    """One cold estimation call (fresh clouds without normals) under
    torch.profiler: wall seconds, device-busy ms (the kernels' device time,
    one stream) and the idle share, with the kernels that took the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    a = Cloud.from_numpy(origin[0], colors=origin[1], device=dev)
    b = Cloud.from_numpy(reconst[0], colors=reconst[1], device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused_evaluate(a, b, color_scheme="ycc", point_to_plane=True,
                       d2_mode="pc_error")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "idle_share": 1 - busy / 1e3 / wall if busy > 0 else "not measured",
            "top_kernels_ms": dict(top)}


@contextlib.contextmanager
def _k7_passes(counts):
    """Count K7's launches by pass in ``counts`` ({"P1", "P2", "P3"}) while
    inside: the adaptive schedule's unseeded call is P1, its seeded call
    right after P1 is P2 (its cap, at least 64, is above p1 = 8, so every
    sweep runs one) and a seeded call after P2 is P3."""
    from open_pcc_metric_tpu_torch.ops import nn_pruned

    real = nn_pruned.adaptive_refine
    last = ["P3"]

    def spy(qhat, bhat, cand, *args, **kw):
        if kw.get("init") is None:
            last[0] = "P1"
        else:
            last[0] = "P2" if last[0] == "P1" else "P3"
        counts[last[0]] += 1
        return real(qhat, bhat, cand, *args, **kw)

    nn_pruned.adaptive_refine = spy
    try:
        yield
    finally:
        nn_pruned.adaptive_refine = real


def _rows_of(args, rows):
    """The per-tile arguments of a refine call restricted to the tile rows
    ``rows``, which keep reading their own queries through global ids."""
    import torch

    out = {}
    for key, val in args.items():
        if isinstance(val, tuple):
            out[key] = tuple(x[rows].contiguous() for x in val)
        elif isinstance(val, torch.Tensor):
            out[key] = val[rows].contiguous()
        else:
            out[key] = val
    if args.get("tiles") is None:
        out["tiles"] = rows.to(torch.int32)
    return out


def _full_phase(records):
    """The first phase whose plain version ran on the full call."""
    return next(r for r in records if r["plain_ms"] is not None)


def _guarded(modules_names):
    """Replace plain versions by guards that raise on a CUDA tensor;
    returns a function that restores them."""
    saved = []
    for mod, name in modules_names:
        plain = getattr(mod, name)

        def guard(q_sorted, *args, _plain=plain, _name=name, **kw):
            if q_sorted.is_cuda:
                raise AssertionError(f"a CUDA tensor reached {_name}")
            return _plain(q_sorted, *args, **kw)

        saved.append((mod, name, plain))
        setattr(mod, name, guard)

    def restore():
        for mod, name, plain in saved:
            setattr(mod, name, plain)

    return restore


def _plain_names():
    import importlib

    from open_pcc_metric_tpu_torch.ops import nn, refine, refine_adaptive, select

    # the module: ops/__init__.py rebinds ``ops.knn`` to the function
    knn_mod = importlib.import_module("open_pcc_metric_tpu_torch.ops.knn")
    return [(refine, "refine_nn_reference"), (refine, "refine_knn_reference"),
            (refine, "knn_moments_reference"), (nn, "nn_chunked"),
            (select, "select_bbox_reference"),
            (select, "count_bbox_reference"),
            (refine_adaptive, "adaptive_refine_reference"),
            (refine, "refine_nn_payload_reference"),
            (refine, "select_candidates_reference"),
            (refine, "refine_nn_straight_reference"),
            (refine, "refine_knn_straight_reference"),
            (knn_mod, "knn_chunked")]


def _wrappers():
    """Each kernel's wrapper, which counts its launches."""
    from open_pcc_metric_tpu_torch.ops import nn, refine, refine_adaptive, select
    from open_pcc_metric_tpu_torch.ops.knn import knn

    return {"refine_nn": refine.refine_nn, "refine_knn": refine.refine_knn,
            "knn_moments": refine.knn_moments, "nn_brute": nn.nn_argmin,
            "select_bbox": select.select_bbox,
            "count_bbox": select.count_bbox,
            "adaptive_refine": refine_adaptive.adaptive_refine,
            "refine_nn_payload": refine.refine_nn_payload,
            "select_candidates": refine.select_candidates,
            "refine_nn_straight": refine.refine_nn_straight,
            "refine_knn_straight": refine.refine_knn_straight,
            "refine_nn_fused": refine.refine_nn_fused,
            "knn_brute": knn}


@contextlib.contextmanager
def _env(values):
    """The environment variables ``values`` set inside (None: unset)."""
    saved = {v: os.environ.get(v) for v in values}
    try:
        for v, value in values.items():
            if value is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = value
        yield
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


def _prologue_env(prologue):
    """PCC_NN_PROLOGUE and PCC_KNN_PROLOGUE set to ``prologue`` inside."""
    return _env({v: prologue for v in PROLOGUE_ENV})


def _check_select_launches(label, prologue, launches):
    """K2a and K2b launched under select, never under the default."""
    for name in SELECT_KERNELS:
        if prologue == "select" and launches[name] <= 0:
            raise AssertionError(f"{label} under select launched {name} "
                                 "no time")
        if prologue != "select" and launches[name] != 0:
            raise AssertionError(f"{label} under the default prologue "
                                 f"launched {name}")


def _reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def _launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def main_path(origin, reconst, dev):
    """fused_evaluate on the 800k pair with normals: one warm-up (grids,
    caches, self-NN), then RUNS timed calls."""
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    (a, b), result, first_s, times, launches = _timed_runs(
        lambda: _pair_clouds(origin, reconst, dev),
        lambda a, b: fused_evaluate(a, b, **kwargs))
    if launches["refine_nn"] <= 0:
        raise AssertionError("the main path launched K1 no time")
    _check_select_launches("the main path", "xla", launches)
    return a, b, result, first_s, times, launches


def estimation_path(origin, reconst, dev, prologue="xla", env=None):
    """fused_evaluate on the pair without normals, fresh clouds per run
    (cold, like bench.py's PCC_BENCH_NORMALS=1), both searches under
    ``prologue`` and the environment ``env``: one warm-up, then the median
    of EST_RUNS. Returns the last run's clouds and result."""
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    def make():
        a = Cloud.from_numpy(origin[0], colors=origin[1], device=dev)
        b = Cloud.from_numpy(reconst[0], colors=reconst[1], device=dev)
        torch.cuda.synchronize()
        return a, b

    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    restore = _guarded(_plain_names())
    try:
        with _prologue_env(prologue), _env(env or {}):
            _reset_launches()
            a, b = make()
            t0 = time.perf_counter()
            result = fused_evaluate(a, b, **kwargs)
            first_s = time.perf_counter() - t0
            times = []
            for _ in range(EST_RUNS):
                a, b = make()
                t0 = time.perf_counter()
                result = fused_evaluate(a, b, **kwargs)
                times.append(time.perf_counter() - t0)
            launches = _launches()
    finally:
        restore()
    for name in ("refine_nn", "refine_knn", "knn_moments"):
        if launches[name] <= 0:
            raise AssertionError(f"the estimation path launched {name} no time")
    _check_select_launches("the estimation path", prologue, launches)
    return a, b, result, first_s, times, launches


def _want_psnrs(origin, reconst, sweeps, nrm0, nrm1):
    """float64 PSNRs of the suite from oracle NN sweeps and given normals."""
    from open_pcc_metric_tpu_torch.ops.obb import minimal_obb_extent

    pts0, col0 = origin[0], origin[1]
    pts1, col1 = reconst[0], reconst[1]
    (i0, d0), (i1, d1), (_, ds) = (sweeps["a->b"], sweeps["b->a"],
                                   sweeps["self a->a"])
    m = np.array([[0.2126, 0.7152, 0.0722],
                  [-0.1146, -0.3854, 0.5],
                  [0.5, -0.4542, -0.0458]])
    # The oracle's peak stays in numpy (device=False): the float64
    # reference is independent of the port's sweep on the card.
    peak = minimal_obb_extent(pts0, device=False).max()
    hpeak2 = np.sqrt(ds).max() ** 2
    p0 = ((pts0 - pts1[i0]) * nrm1[i0]).sum(1) ** 2
    p1 = ((pts1 - pts0[i1]) * nrm0[i1]).sum(1) ** 2
    c0 = ((col0 - col1[i0]) @ m.T) ** 2
    c1 = ((col1 - col0[i1]) @ m.T) ** 2
    want = {}
    for side, dd, pp, cc in (("left", d0, p0, c0), ("right", d1, p1, c1)):
        want[f"geo_psnr_{side}"] = 10 * np.log10(peak**2 / dd.mean())
        want[f"geo_hausdorff_psnr_{side}"] = 10 * np.log10(hpeak2 / dd.max())
        want[f"d2_psnr_{side}"] = 10 * np.log10(peak**2 / pp.mean())
        want[f"d2_hausdorff_psnr_{side}"] = 10 * np.log10(hpeak2 / pp.max())
        want[f"color_psnr_{side}"] = 10 * np.log10(1.0 / cc.mean(0))
    return want


def _psnr_deltas(result, want):
    return {k: float(np.max(np.abs(np.asarray(result[k], np.float64) - v)))
            for k, v in want.items()}


def oracle_checks(a, b, origin, reconst, result, search, label):
    """The three NN sweeps that ``search(q, s, exclude_self)`` gives (padded
    original-order ``(idx, dist_sq)``) bit-exact vs the scipy float64
    oracle, and the PSNRs vs a float64 numpy evaluation built from the
    oracle neighbours. Returns (oracle sweeps, max |dPSNR|)."""
    import bench

    sweeps = {}
    for name, q, s, qp, sp, ex in (
            ("a->b", a, b, origin[0], reconst[0], False),
            ("b->a", b, a, reconst[0], origin[0], False),
            ("self a->a", a, a, origin[0], origin[0], True)):
        i, d = search(q, s, ex)
        i = i[: q.n].cpu().numpy()
        d = d[: q.n].double().cpu().numpy()
        oi, od = bench._oracle_nn_fast(qp, sp, exclude_self=ex)
        bad = int(np.sum((oi != i) | (od != d)))
        print(f"{label}sweep {name}: {q.n} queries, {bad} differ from the "
              "oracle", flush=True)
        if bad:
            raise AssertionError(f"{label}sweep {name}: {bad} rows differ "
                                 "from the float64 oracle")
        sweeps[name] = (oi, od)
    want = _want_psnrs(origin, reconst, sweeps, origin[2], reconst[2])
    delta = max(_psnr_deltas(result, want).values())
    print(f"{label}max |dPSNR| vs float64 oracle evaluation: {delta:.3e} dB "
          f"({len(want)} PSNR entries)", flush=True)
    if not delta <= PSNR_TOL:
        raise AssertionError(f"{label}PSNR parity: max |delta| {delta:.3e} "
                             "> 1e-4 dB")
    return sweeps, delta


def _settled_rung(q, s, refine_impl="default", payload=False):
    """The rung the fused ladder settled on under one schedule (the memo's
    key names it) for the pair that holds the clouds ``q`` and ``s`` (the
    base rung if it has none or several)."""
    from open_pcc_metric_tpu_torch.ops.fused import _LADDER_MEMO

    sizes = {q.padded_size, s.padded_size}
    rungs = {rung for key, (rung, _) in _LADDER_MEMO.items()
             if sizes <= set(key[:2]) and key[-2:] == (refine_impl, payload)}
    return rungs.pop() if len(rungs) == 1 else (CAP, FALLBACK)


def pruned_search(q, s, exclude_self, prologue="xla", refine_impl="default",
                  sched="counted"):
    """The main path's pruned sweep at the rung its ladder settled on, under
    ``prologue``, ``refine_impl`` (integer clouds: mxu_ok) and ``sched``."""
    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        nn_pruned_sorted, unsort_nn_result)

    cap, ft = _settled_rung(q, s, refine_impl)
    gq, gs = q.get_grid(), s.get_grid()
    d_s, i_s, ov = nn_pruned_sorted(gq, gs, q.n, exclude_self=exclude_self,
                                    cap=cap, fallback_tiles=ft,
                                    prologue=prologue, refine_impl=refine_impl,
                                    mxu_ok=q.mxu_exact() and s.mxu_exact(),
                                    sched=sched)
    if bool(ov):
        raise AssertionError(f"a sweep overflowed at rung {(cap, ft)}")
    d, i = unsort_nn_result(gq, gs, d_s, i_s)
    return i, d


def brute_search(q, s, exclude_self):
    """The small-cloud path's sweep: the dispatcher, which takes K5."""
    from open_pcc_metric_tpu_torch.ops.nn import nearest_neighbors

    return nearest_neighbors(q.points, s.points, exclude_self=exclude_self)


def estimation_checks(a, b, origin, reconst, result, sweeps, oracle,
                      prologue="xla", sched="counted"):
    """The port's 30-NN sets of both clouds (searched under ``prologue``
    and ``sched``) against the exact float64 scipy oracle (0 rows may
    differ), its normals against float64 LAPACK normals of those sets
    (0.001-quantile of |dot| above 0.999), and the PSNRs against a float64
    evaluation with those normals: D2 entries within D2_TOL, the others
    within PSNR_TOL. Under select or the fixed schedule the k-NN sets must
    also equal the default's bit for bit. ``oracle`` caches the oracle's
    sets and LAPACK normals by cloud. Returns the numbers."""
    import bench
    from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned

    lapack = {}
    out = {}
    for name, c, pts in (("origin", a, origin[0]), ("reconst", b, reconst[0])):
        if name not in oracle:
            oi, _ = bench._oracle_knn_fast(pts, pts, K)
            neigh = pts[oi]
            cen = neigh - neigh.mean(axis=1, keepdims=True)
            cov = np.einsum("nki,nkj->nij", cen, cen) / K
            oracle[name] = (oi, np.linalg.eigh(cov)[1][:, :, 0])
        oi, lapack[name] = oracle[name]
        idx, dist = knn_pruned(c.points, c.points, c.n, c.n, k=K,
                               cap=KCAP, fallback_tiles=KFT,
                               prologue=prologue, sched=sched)
        bad = int(np.any(idx[: c.n].cpu().numpy() != oi, axis=1).sum())
        if prologue == "select" or sched == "fixed":
            idx0, dist0 = knn_pruned(c.points, c.points, c.n, c.n, k=K,
                                     cap=KCAP, fallback_tiles=KFT,
                                     prologue="xla", sched="counted")
            if not (_bit_equal(idx[: c.n], idx0[: c.n])
                    and _bit_equal(dist[: c.n], dist0[: c.n])):
                raise AssertionError(f"estimation {name}: the {prologue} "
                                     f"{sched} k-NN sets differ from the "
                                     "default's")
            out[f"{name}_knn_equal_to_default"] = True
        est = c._est_normals[: c.n].double().cpu().numpy()
        q001 = float(np.quantile(np.abs((est * lapack[name]).sum(1)), 0.001))
        print(f"estimation {name} ({prologue}, {sched}): {c.n} points, "
              f"{bad} k-NN rows "
              "differ from the float64 oracle; normals |dot| 0.001-quantile "
              f"{q001:.6f} vs float64 LAPACK", flush=True)
        if bad:
            raise AssertionError(f"estimation {name}: {bad} k-NN rows differ")
        if not q001 > 0.999:
            raise AssertionError(f"estimation {name}: normals |dot| "
                                 f"0.001-quantile {q001} <= 0.999")
        out[name] = {"knn_rows_differ": bad, "normals_dot_q001": q001}
    want = _want_psnrs(origin, reconst, sweeps, lapack["origin"],
                       lapack["reconst"])
    deltas = _psnr_deltas(result, want)
    d2 = max(v for k, v in deltas.items() if k.startswith("d2_"))
    rest = max(v for k, v in deltas.items() if not k.startswith("d2_"))
    print(f"estimation ({prologue}, {sched}) max |dPSNR| vs float64 "
          "evaluation: D2 "
          f"entries {d2:.3e} dB (bar {D2_TOL:g}), D1/colour/Hausdorff "
          f"{rest:.3e} dB "
          f"(bar {PSNR_TOL:g})", flush=True)
    if not (d2 <= D2_TOL and rest <= PSNR_TOL):
        raise AssertionError(f"estimation PSNR parity: D2 {d2:.3e}, "
                             f"others {rest:.3e}")
    out["max_dpsnr_d2"], out["max_dpsnr_other"] = d2, rest
    return out


def brute_phases(a, b, float_cloud):
    """K5 against nn_chunked on the card at the small-cloud path's shapes:
    a->b, b->a, self a->a with exclude_self, and a float cloud -> b. Index
    and distance must be bit-identical. The plain version runs on all rows
    unless a timed 2048-row slice predicts more than PLAIN_BUDGET_S, then on
    a stated leading block of rows. Each phase gives the kernel's query rows
    a thread (R), its split of b's rows and blocks, registers and blocks an
    SM. The a->b phase also times one PyTorch library call for the same
    function, ``torch.cdist(a, b).min(dim=1)`` (two kernels, not
    bit-equal; a yardstick the port never calls)."""
    import torch

    from open_pcc_metric_tpu_torch.ops import nn

    records = []
    for name, q, s, ex in (("a->b", a, b, False), ("b->a", b, a, False),
                           ("self a->a", a, a, True),
                           ("float a->b", float_cloud, b, False)):
        qp, sp = q.points, s.points
        gi, gd = nn.nn_argmin(qp, sp, ex)
        torch.cuda.synchronize()
        na, nb = qp.shape[0], sp.shape[0]
        _, slice_ms = _once_ms(lambda: nn.nn_chunked(qp[:2048], sp, ex))
        predicted_s = slice_ms * na / 2048 / 1e3
        rows, note = na, None
        if predicted_s > PLAIN_BUDGET_S:
            rows = max(2048, int(na * PLAIN_BUDGET_S / predicted_s) // 256 * 256)
            note = (f"plain version compared on the first {rows} of {na} "
                    f"rows: all rows were predicted to take {predicted_s:.0f} s")
        (wi, wd), plain_ms = _once_ms(lambda: nn.nn_chunked(qp[:rows], sp, ex))
        if not (_bit_equal(gi[:rows], wi) and _bit_equal(gd[:rows], wd)):
            bad = int(((gi[:rows] != wi) | (gd[:rows] != wd)).sum())
            raise AssertionError(f"K5 phase {name}: {bad} rows differ from "
                                 "nn_chunked")
        bound_ms, bound_by = _bound(OPS_PER_PAIR * na * nb, [qp, sp], [gi, gd])
        regs, per_sm = nn.occupancy()
        splits = nn.split_count(na, nb, nn.sm_count(qp.device), per_sm)
        rec = {
            "phase": name, "rows": int(na), "search_rows": int(nb),
            "valid_rows": [int(q.n), int(s.n)], "max_abs_err": 0.0,
            "rows_a_thread": nn.ROWS, "splits": splits,
            "blocks": -(-na // (nn._THREADS * nn.ROWS)) * splits,
            "registers": regs, "blocks_per_sm": per_sm,
            "ms": _time_ms(lambda: nn.nn_argmin(qp, sp, ex), 20),
            "plain_ms": plain_ms if rows == na else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if note:
            rec["plain_subset"] = note
            rec["plain_subset_ms"] = plain_ms
        if name == "a->b":
            rec["library_ms"] = _time_ms(
                lambda: torch.cdist(qp, sp).min(dim=1), 3)
        print("kernel phase " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def knn_brute_phases(dev, seed=0):
    """K8 against knn_chunked on the card, self searches at k = K: voxel
    surfaces of 56000 and 14000 points (57344 and 14336 padded rows), the
    QP 18 and QP 30 frames of an 800k origin (``datasets.degrade_gpcc_like``,
    cell 2's brute-path frames), a jittered float cloud and a shuffled one
    (neighbours met out of row order) at 57344 rows. Index and distance
    must be bit-identical. Each phase gives K8's ms (CUDA events), the
    plain version's, the bound (OPS_PER_PAIR a pair), registers and blocks
    an SM; the 57344 and 14336 phases also time ``torch.cdist`` plus
    ``torch.topk`` (``library_ms``: times only, topk orders ties
    arbitrarily; a yardstick the port never calls). Then
    ``estimate_normals_cloud`` on the QP 18 frame gives the plain path's
    normals bit for bit, and ``small_estimation_path`` counts K8's launches
    on the QP 18 pair. Returns (records, launches on that path)."""
    import importlib

    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.datasets import (degrade_gpcc_like,
                                                    voxel_surface)
    from open_pcc_metric_tpu_torch.ops import normals, refine

    knn_mod = importlib.import_module("open_pcc_metric_tpu_torch.ops.knn")
    origin, colors, _ = voxel_surface(N_POINTS, seed=seed)
    frames = {qp: degrade_gpcc_like(origin, colors, qp, seed=seed)[0]
              for qp in (18, 30)}
    rng = np.random.default_rng(seed)
    surf = voxel_surface(56000, seed=seed)[0]
    clouds = [
        ("self 57344", surf),
        ("self 14336", voxel_surface(14000, seed=seed)[0]),
        ("qp18 frame self", frames[18]),
        ("qp30 frame self", frames[30]),
        ("float self 57344", surf + rng.uniform(-0.5, 0.5, surf.shape)),
        ("shuffled self 57344", surf[rng.permutation(surf.shape[0])]),
    ]
    regs, per_sm = refine.occupancy("knn_brute")
    records = []
    for name, pts in clouds:
        p = Cloud.from_numpy(pts, device=dev).points
        n = p.shape[0]
        (gi, gd), first_ms = _once_ms(lambda: knn_mod.knn(p, p, K))
        (wi, wd), plain_ms = _once_ms(lambda: knn_mod.knn_chunked(p, p, K))
        if not (_bit_equal(gi, wi) and _bit_equal(gd, wd)):
            bad = int(((gi != wi) | (gd != wd)).any(dim=1).sum())
            raise AssertionError(f"K8 phase {name}: {bad} rows differ from "
                                 "knn_chunked")
        bound_ms, bound_by = _bound(OPS_PER_PAIR * n * n, [p, p], [gi, gd])
        rec = {
            "phase": name, "rows": int(n), "k": K, "max_abs_err": 0.0,
            "ms": _time_ms(lambda: knn_mod.knn(p, p, K), 20),
            "first_call_ms": first_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "registers": regs, "blocks_per_sm": per_sm,
        }
        if name in ("self 57344", "self 14336"):
            rec["library_ms"] = _time_ms(
                lambda: torch.topk(torch.cdist(p, p), K, dim=1,
                                   largest=False), 3)
        print("kernel phase " + json.dumps(rec), flush=True)
        records.append(rec)
        del p, gi, gd, wi, wd
        torch.cuda.empty_cache()

    got = normals.estimate_normals_cloud(Cloud.from_numpy(frames[18],
                                                          device=dev))
    fast = knn_mod.knn
    knn_mod.knn = knn_mod.knn_chunked
    try:
        want = normals.estimate_normals_cloud(Cloud.from_numpy(frames[18],
                                                               device=dev))
    finally:
        knn_mod.knn = fast
    if not _bit_equal(got, want):
        raise AssertionError("the QP 18 estimation's normals differ from "
                             "the plain path's")
    print("small-cloud estimation " + json.dumps({
        "points": int(frames[18].shape[0]),
        "normals_bit_identical_to_plain": True}), flush=True)
    del got, want
    torch.cuda.empty_cache()
    return records, small_estimation_path(
        (origin, colors), degrade_gpcc_like(origin, colors, 18, seed=seed),
        dev)


def ply_decode_phases(dev, smi, seed=0):
    """K9 against the host path, from file to device, on the benchmark's
    files (``io.write_ply``: float64 x, y, z, float64 normals on the
    original, uchar colours): an 800k original and its QP 6 frame
    (``datasets.degrade_gpcc_like``). Each phase holds ``load_cloud``'s
    cloud (K9) to the host path's (``read_point_cloud`` plus
    ``Cloud.from_numpy``) bit for bit, ``mxu_exact`` too, and gives the
    median wall ms of RUNS loads of each (``load_ms``, ``host_ms``: from
    the file to the device, synchronised; warm page cache) and the decoded
    load's parts, which add up to about ``load_ms``: ``header_ms`` (the
    header parse, wall), ``read_ms`` (the vertex block read into a pinned
    buffer already held, wall), ``copy_ms`` (the raw records' copy, CUDA
    events) and ``ms`` (K9 alone, its memset and kernel: CUDA events over
    launches captured in one CUDA graph); besides ``stage_ms`` (wall of
    ``ply_decode.stage``: header, a buffer from torch's pinned cache and
    the read), ``eager_ms`` (K9's wrapper called eagerly, CUDA events: its
    host time where that is longer), K9's plain version on the card
    (``plain_ms``), the bytes bound, and the registers and blocks an SM
    that the CUDA runtime gives for the kernel as built. Returns (records,
    K9 launches on the decoded loads)."""
    import tempfile

    import torch

    from open_pcc_metric_tpu_torch import evaluate
    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.datasets import (degrade_gpcc_like,
                                                    voxel_surface)
    from open_pcc_metric_tpu_torch.io import (ply_decode, read_point_cloud,
                                              write_ply)
    from open_pcc_metric_tpu_torch.ops import refine

    pts, colors, nrm = voxel_surface(N_POINTS, seed=seed)
    frame, fcolors = degrade_gpcc_like(pts, colors, 6, seed=seed)
    regs, per_sm = refine.occupancy("ply_decode")
    records, launches = [], 0

    def wall_ms(fn):
        times = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    with tempfile.TemporaryDirectory() as tmp:
        files = [("original 800k", os.path.join(tmp, "o.ply"), pts, colors,
                  nrm),
                 ("qp6 frame", os.path.join(tmp, "f.ply"), frame, fcolors,
                  None)]
        for name, path, p, c, n in files:
            write_ply(path, p, colors=c, normals=n)
            def host_load():
                raw = read_point_cloud(path)
                return Cloud.from_numpy(raw.points, raw.colors, raw.normals,
                                        device=dev)

            host, host_ms = wall_ms(host_load)
            before = ply_decode.decode_records.launches
            got, load_ms = wall_ms(lambda: evaluate.load_cloud(path,
                                                               device=dev))
            launches += ply_decode.decode_records.launches - before
            for attr in ("points", "colors", "normals"):
                g, w = getattr(got, attr), getattr(host, attr)
                if (g is None) != (w is None) or (
                        g is not None and not _bit_equal(g, w)):
                    raise AssertionError(f"K9 phase {name}: {attr} differ "
                                         "from the host path's")
            if got.mxu_exact() != host.mxu_exact():
                raise AssertionError(f"K9 phase {name}: mxu_exact differs")
            lay, header_ms = wall_ms(lambda: ply_decode.layout(path))
            staged, stage_ms = wall_ms(lambda: ply_decode.stage(
                path, "float32", dev))
            held = memoryview(staged.records.numpy())[:lay.n * lay.stride]

            def read_into():
                with open(path, "rb") as f:
                    f.seek(lay.offset)
                    f.readinto(held)

            _, read_ms = wall_ms(read_into)
            raw = staged.records.to(dev)
            pad = got.padded_size
            copy_ms = _time_ms(lambda: staged.records.to(dev,
                                                         non_blocking=True),
                               10)
            outs = ply_decode.decode_records(raw, lay, pad)
            (_, plain_ms) = _once_ms(lambda: ply_decode.decode_reference(
                raw, lay, pad))
            want = ply_decode.decode_reference(raw, lay, pad)
            for g, w in zip(outs, want):
                if (g is None) != (w is None) or (
                        g is not None and not _bit_equal(g, w)):
                    raise AssertionError(f"K9 phase {name}: the kernel "
                                         "differs from its plain version")
            bound_ms, bound_by = _bound_of(
                0, lay.n * lay.stride + sum(
                    x.numel() * x.element_size() for x in outs[:3]
                    if x is not None))
            rec = {
                "phase": name, "points": lay.n, "padded_rows": pad,
                "record_bytes": lay.stride, "max_abs_err": 0.0,
                "ms": _graph_ms(lambda: ply_decode.decode_records(
                    raw, lay, pad), 20),
                "eager_ms": _time_ms(lambda: ply_decode.decode_records(
                    raw, lay, pad), 20),
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "header_ms": header_ms,
                "read_ms": read_ms, "copy_ms": copy_ms, "stage_ms": stage_ms,
                "load_ms": load_ms, "host_ms": host_ms,
                "mxu_exact": got.mxu_exact(),
                "host_points_kept": got.host_points is not None,
                "registers": regs, "blocks_per_sm": per_sm, "card": smi,
            }
            print("kernel phase K9 " + json.dumps(rec), flush=True)
            records.append(rec)
            del host, got, staged, held, raw, outs, want
            torch.cuda.empty_cache()
    return records, launches


def small_estimation_path(origin, frame, dev):
    """fused_evaluate on a pair of cell 2's shape, no normals on either
    side: the 800k origin and its QP 18 frame (56k points, 57344 rows,
    below the pruning threshold), ``origin`` and ``frame`` as (points,
    colors). Every call builds both clouds afresh, as the CLI loads them,
    so every call estimates both clouds' normals, the frame's 30-NN
    through K8. One warm-up and RUNS timed calls (``_timed_runs``: every
    plain version, ``knn_chunked`` included, guarded). Returns the K8
    launches, one a call."""
    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")

    def evaluate(o, f):
        a = Cloud.from_numpy(o[0], colors=o[1], device=dev)
        b = Cloud.from_numpy(f[0], colors=f[1], device=dev)
        return fused_evaluate(a, b, **kwargs)

    _, _, first_s, times, launches = _timed_runs(lambda: (origin, frame),
                                                 evaluate)
    if launches["knn_brute"] != RUNS + 1:
        raise AssertionError(f"the QP 18 pair launched K8 "
                             f"{launches['knn_brute']} times in {RUNS + 1} "
                             "calls, not one a call")
    if launches["refine_knn"] <= 0:
        raise AssertionError("the QP 18 pair's origin took no pruned k-NN")
    med = statistics.median(times)
    print("small-cloud estimation path " + json.dumps({
        "n_points": int(origin[0].shape[0] + frame[0].shape[0]),
        "first_call_s": first_s, "times_s": times, "median_s": med,
        "k8_launches": launches["knn_brute"],
        "k3_launches": launches["refine_knn"]}), flush=True)
    return launches["knn_brute"]


def _timed_runs(make, evaluate, runs=RUNS):
    """One warm-up and ``runs`` timed calls of ``evaluate`` on the clouds
    ``make`` gives once, every plain version guarded and the launch counts
    set to 0 just before and read just after. Returns (clouds, result,
    first-call s, times, launches)."""
    clouds = make()
    restore = _guarded(_plain_names())
    try:
        _reset_launches()
        t0 = time.perf_counter()
        result = evaluate(*clouds)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            result = evaluate(*clouds)  # ends in a host readback
            times.append(time.perf_counter() - t0)
        launches = _launches()
    finally:
        restore()
    return clouds, result, first_s, times, launches


def _pair_clouds(origin, reconst, dev):
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud

    a = Cloud.from_numpy(origin[0], colors=origin[1], normals=origin[2],
                         device=dev)
    b = Cloud.from_numpy(reconst[0], colors=reconst[1], normals=reconst[2],
                         device=dev)
    torch.cuda.synchronize()
    return a, b


def small_path(origin, reconst, dev):
    """fused_evaluate on the 60k pair with normals: the brute force (K5)
    only, no grid and no K1."""
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    (a, b), result, first_s, times, launches = _timed_runs(
        lambda: _pair_clouds(origin, reconst, dev),
        lambda a, b: fused_evaluate(a, b, **kwargs))
    if launches["nn_brute"] <= 0:
        raise AssertionError("the small-cloud path launched K5 no time")
    if launches["refine_nn"] or a._grid is not None:
        raise AssertionError("the small-cloud path reached the pruned search")
    return a, b, result, first_s, times, launches


def dag_path(origin, reconst, dev, kernel):
    """evaluate_pair(engine="dag") on fresh clouds with normals, counted,
    then the fused table on the same clouds: every PSNR within PSNR_TOL and
    every other value within ENGINE_RTOL. ``kernel`` must have launched."""
    from open_pcc_metric_tpu_torch.evaluate import evaluate_pair
    from open_pcc_metric_tpu_torch.options import CalculateOptions

    opts = CalculateOptions(color="ycc", hausdorff=True, point_to_plane=True,
                            d2_mode="pc_error")
    a, b = _pair_clouds(origin, reconst, dev)
    restore = _guarded(_plain_names())
    try:
        _reset_launches()
        t0 = time.perf_counter()
        dag = evaluate_pair(a, b, opts, engine="dag").as_dict()
        dag_s = time.perf_counter() - t0
        launches = _launches()
    finally:
        restore()
    if launches[kernel] <= 0:
        raise AssertionError(f"the DAG path launched {kernel} no time")
    fused = evaluate_pair(a, b, opts, engine="fused").as_dict()
    if list(dag) != list(fused):
        raise AssertionError("the DAG and fused tables have other rows")
    dpsnr, rel = 0.0, 0.0
    for key, want in fused.items():
        g = np.asarray(dag[key], np.float64)
        w = np.asarray(want, np.float64)
        if "PSNR" in key[0]:
            dpsnr = max(dpsnr, float(np.max(np.abs(g - w))))
        else:
            rel = max(rel, float(np.max(np.abs(g - w)
                                        / np.maximum(np.abs(w), 1e-30))))
    if not (dpsnr <= PSNR_TOL and rel <= ENGINE_RTOL):
        raise AssertionError(f"DAG vs fused: max |dPSNR| {dpsnr:.3e} dB, "
                             f"max rel {rel:.3e}")
    return {"n_points": a.n + b.n, "rows": len(dag), "dag_s": dag_s,
            "max_dpsnr_vs_fused": dpsnr, "max_rel_vs_fused": rel,
            "launches": {k: v for k, v in launches.items() if v}}



def select_phases(cases):
    """K2a and K2b against their plain versions on the card, at the select
    prologue's shapes. ``cases`` are (name, query grid, search grid, valid
    queries, cap, exclude_self). K2a must give bit-identical cand and
    lb_sel; K2b, at the threshold of the K1 probe over K2a's first P1
    chunks, bit-identical counts at the automatic split and at one block a
    tile group, each timed eager and in a CUDA graph (``graph_ms``: the
    kernel without the wrapper's host time), with its registers and blocks
    an SM. Returns (K2a records, K2b records)."""
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import cert_ub, tile_boxes
    from open_pcc_metric_tpu_torch.ops.refine import (
        occupancy, refine_nn, sm_count)
    from open_pcc_metric_tpu_torch.ops.select import (
        count_bbox, count_bbox_reference, count_split, select_bbox,
        select_bbox_reference)

    k2b_occ = occupancy("count_bbox")
    k2a, k2b = [], []
    for name, gq, gs, nq, cap, ex in cases:
        valid_t, a_lo, a_hi = tile_boxes(gq, nq)
        boxes = (a_lo, a_hi, gs.bbox_lo, gs.bbox_hi)
        nta, ncb = a_lo.shape[0], gs.n_chunks
        cap = min(cap, ncb)
        cand, lb_sel = select_bbox(*boxes, cap)
        torch.cuda.synchronize()
        want_c, want_l = select_bbox_reference(*boxes, cap)
        if not (_bit_equal(cand, want_c) and _bit_equal(lb_sel, want_l)):
            bad = int(((cand != want_c) | (lb_sel != want_l)).sum())
            raise AssertionError(f"K2a phase {name}: {bad} entries differ "
                                 "from select_bbox_reference")
        bound_ms, bound_by = _bound(OPS_SELECT * nta * ncb, boxes,
                                    [cand, lb_sel])
        rec = {
            "phase": name, "tiles": nta, "chunks": ncb, "cap": cap,
            "max_abs_err": 0.0,
            "ms": _time_ms(lambda: select_bbox(*boxes, cap), 20),
            "graph_ms": _graph_ms(lambda: select_bbox(*boxes, cap), 20),
            "plain_ms": _time_ms(lambda: select_bbox_reference(*boxes, cap),
                                 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            **_k2a_occupancy(ncb, cap),
        }
        print("kernel phase K2a " + json.dumps(rec), flush=True)
        k2a.append(rec)

        d1, _ = refine_nn(gq.points, gs.points, gs.perm,
                          cand[:, :P1].contiguous(), exclude_self=ex)
        thr = cert_ub(d1, valid_t)
        want = count_bbox_reference(*boxes, thr)
        for splits in (None, 1):
            cnt = count_bbox(*boxes, thr, splits=splits)
            torch.cuda.synchronize()
            if not _bit_equal(cnt, want):
                raise AssertionError(
                    f"K2b phase {name} at splits={splits}: "
                    f"{int((cnt != want).sum())} counts differ from "
                    "count_bbox_reference")
        nbytes = sum(x.numel() * x.element_size() for x in (*boxes, thr, cnt))
        bound_ms, bound_by = _bound_of(_count_ops(*boxes, thr), nbytes)
        regs, per_sm = k2b_occ
        rec = {
            "phase": name + " (probe threshold)", "tiles": nta, "chunks": ncb,
            "mean_count": float(cnt.float().mean()), "max_abs_err": 0.0,
            "ms": _time_ms(lambda: count_bbox(*boxes, thr), 20),
            "graph_ms": _graph_ms(lambda: count_bbox(*boxes, thr), 20),
            "splits": count_split(nta, ncb, sm_count(thr.device)),
            "ms_splits_1": _time_ms(
                lambda: count_bbox(*boxes, thr, splits=1), 20),
            "graph_ms_splits_1": _graph_ms(
                lambda: count_bbox(*boxes, thr, splits=1), 20),
            "plain_ms": _time_ms(lambda: count_bbox_reference(*boxes, thr), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bound_all_pairs_ms": _bound_of(OPS_COUNT * nta * ncb, nbytes)[0],
            "registers": regs, "blocks_per_sm": per_sm,
        }
        print("kernel phase K2b " + json.dumps(rec), flush=True)
        k2b.append(rec)
    return k2a, k2b


def _k2a_occupancy(ncb, cap):
    """K2a's registers, blocks an SM and dynamic shared bytes at (ncb, cap),
    and which design the call takes."""
    from open_pcc_metric_tpu_torch.ops.select import occupancy

    regs, per_sm, smem = occupancy(ncb, cap)
    return {"design": "shared keys" if smem else "recompute",
            "registers": regs, "blocks_per_sm": per_sm, "shared_bytes": smem}


def k2a_wide_phases(dev, n_tiles=64, n_chunks=60_000, seed=7):
    """K2a above its shared-key limit (``select.SHARED_MAX_CHUNKS``), where
    it takes the first design: ``n_tiles`` random query-tile boxes against
    ``n_chunks`` random chunk boxes made from ``seed`` (coordinates in
    [0, 4000), sides up to 40), cap 32 and 1024, bit-identical to
    ``select_bbox_reference``."""
    import torch

    from open_pcc_metric_tpu_torch.ops.select import (
        SHARED_MAX_CHUNKS, select_bbox, select_bbox_reference)

    if n_chunks <= SHARED_MAX_CHUNKS:
        raise AssertionError("the wide K2a case is not above the limit")
    rng = np.random.default_rng(seed)
    lo_a = rng.uniform(0, 4000, (n_tiles, 3))
    lo_b = rng.uniform(0, 4000, (n_chunks, 3))
    boxes = [torch.tensor(x, dtype=torch.float32, device=dev) for x in (
        lo_a, lo_a + rng.uniform(0, 40, lo_a.shape), lo_b,
        lo_b + rng.uniform(0, 40, lo_b.shape))]
    recs = []
    for cap in (32, 1024):
        cand, lb_sel = select_bbox(*boxes, cap)
        torch.cuda.synchronize()
        want, plain_ms = _once_ms(lambda: select_bbox_reference(*boxes, cap))
        if not (_bit_equal(cand, want[0]) and _bit_equal(lb_sel, want[1])):
            raise AssertionError(f"K2a wide phase cap {cap}: differs from "
                                 "select_bbox_reference")
        bound_ms, bound_by = _bound(OPS_SELECT * n_tiles * n_chunks, boxes,
                                    [cand, lb_sel])
        rec = {
            "phase": f"random {n_tiles} x {n_chunks}, cap {cap}",
            "tiles": n_tiles, "chunks": n_chunks, "cap": cap,
            "max_abs_err": 0.0,
            "ms": _time_ms(lambda: select_bbox(*boxes, cap), 10),
            "graph_ms": _graph_ms(lambda: select_bbox(*boxes, cap), 10),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, **_k2a_occupancy(n_chunks, cap),
        }
        print("kernel phase K2a " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def prologue_ab(label, sweeps, smi):
    """The two prologues of one sweep, timed in turns (default, select,
    select, default; CUDA events, mean of 10 calls each turn): the default
    is ``tile_bounds`` (the lb matrix and its stable sort) and the two
    certificate counts over the matrix, select is K2a and two K2b counts,
    both at the thresholds the sweep itself reaches (the probe's and
    stage 1's). ``sweeps`` are (name, query grid, search grid, valid
    queries, exclude_self). Returns {sweep: {"xla": ms, "select": ms}}."""
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        cert_ub, count_under, nn_pruned_sorted, tile_bounds, tile_boxes)
    from open_pcc_metric_tpu_torch.ops.refine import refine_nn
    from open_pcc_metric_tpu_torch.ops.select import count_bbox, select_bbox

    out = {}
    for name, gq, gs, nq, ex in sweeps:
        valid_t, a_lo, a_hi = tile_boxes(gq, nq)
        boxes = (gs.bbox_lo, gs.bbox_hi)
        cap = min(CAP, gs.n_chunks)
        cand, _ = select_bbox(a_lo, a_hi, *boxes, cap)
        d1, _ = refine_nn(gq.points, gs.points, gs.perm,
                          cand[:, :P1].contiguous(), exclude_self=ex)
        thr1 = cert_ub(d1, valid_t)
        d_s = nn_pruned_sorted(gq, gs, nq, exclude_self=ex, cap=CAP,
                               fallback_tiles=FALLBACK)[0]
        thr2 = cert_ub(d_s.reshape(valid_t.shape), valid_t)
        del cand, d1, d_s

        def default():
            _, lb, order = tile_bounds(gq, gs, nq)
            return order, count_under(lb, thr1), count_under(lb, thr2)

        def select():
            _, lo, hi = tile_boxes(gq, nq)
            order, _ = select_bbox(lo, hi, *boxes, cap)
            return order, count_bbox(lo, hi, *boxes, thr1), count_bbox(
                lo, hi, *boxes, thr2)

        turns = {"xla": [], "select": []}
        for prologue in ("xla", "select", "select", "xla"):
            fn = select if prologue == "select" else default
            turns[prologue].append(_time_ms(fn, 10))
            torch.cuda.empty_cache()
        out[name] = {
            "tiles": int(valid_t.shape[0]), "chunks": int(gs.n_chunks),
            "xla_ms": statistics.mean(turns["xla"]),
            "select_ms": statistics.mean(turns["select"]),
            "turns_ms": turns,
        }
        out[name]["speedup"] = out[name]["xla_ms"] / out[name]["select_ms"]
    print(f"prologue A/B {label} " + json.dumps(
        {"cap": CAP, "sweeps": out, "card": smi}), flush=True)
    return out


def _sweeps(a, b):
    return (("a->b", a, b, False), ("b->a", b, a, False),
            ("self a->a", a, a, True))


def sweeps_identical(a, b, label, oracle=None):
    """Each of the three sweeps under select equals the default prologue's
    bit for bit on the valid rows (and, given ``oracle`` sweeps, has 0 rows
    off them). Returns the rows off the oracle per sweep."""
    off = {}
    for name, q, s, ex in _sweeps(a, b):
        i0, d0 = pruned_search(q, s, ex, "xla")
        i1, d1 = pruned_search(q, s, ex, "select")
        if not (_bit_equal(i0[: q.n], i1[: q.n])
                and _bit_equal(d0[: q.n], d1[: q.n])):
            raise AssertionError(f"{label} sweep {name}: select differs from "
                                 "the default prologue")
        if oracle is not None:
            oi, od = oracle[name]
            off[name] = int(np.sum((oi != i1[: q.n].cpu().numpy())
                                   | (od != d1[: q.n].double().cpu().numpy())))
            if off[name]:
                raise AssertionError(f"{label} sweep {name} under select: "
                                     f"{off[name]} rows off the oracle")
    return off


def _turns(label, order, envs, make, evaluate, runs, check):
    """``evaluate`` on clouds from ``make`` in turns: one per mode of
    ``order``, each one warm-up and ``runs`` timed calls (``_timed_runs``)
    with the environment ``envs[mode]``, then ``check(mode, launches)``.
    Every table must equal the first bit for bit. Returns (last clouds,
    {mode: launches of its first turn}, {mode: [timings]}, the first
    table)."""
    turns = {mode: [] for mode in order}
    launches_of = {}
    first = None
    for mode in order:
        with _env(envs[mode]):
            clouds, result, first_s, times, launches = _timed_runs(
                make, evaluate, runs)
        check(mode, launches)
        if first is None:
            first = result
        elif any(not np.array_equal(np.asarray(result[k]),
                                    np.asarray(first[k])) for k in first):
            raise AssertionError(f"{label}: the {mode} table differs")
        launches_of.setdefault(mode, launches)
        n = clouds[0].n + clouds[1].n
        med = statistics.median(times)
        turns[mode].append({"first_call_s": first_s, "median_s": med,
                            "mpts_per_s": n / med / 1e6})
    return clouds, launches_of, turns, first


def prologue_path(label, make, evaluate, runs, smi, kernel="refine_nn"):
    """``_turns`` (select, default, default, select) under PCC_NN_PROLOGUE
    and PCC_KNN_PROLOGUE: K2a/K2b launch under select only, ``kernel``
    under both. Returns (last clouds, select launches of the first turn,
    the record to print, the first table)."""
    def check(prologue, launches):
        _check_select_launches(label, prologue, launches)
        if launches[kernel] <= 0:
            raise AssertionError(f"{label} launched {kernel} no time")

    envs = {p: {v: p for v in PROLOGUE_ENV} for p in ("select", "xla")}
    clouds, launches_of, turns, first = _turns(
        label, ("select", "xla", "xla", "select"), envs, make, evaluate,
        runs, check)
    launches_sel = launches_of["select"]
    rec = {"n_points": clouds[0].n + clouds[1].n, "runs": runs,
           "turns": turns, "table_equal": True,
           "launches_select": {k: v for k, v in launches_sel.items() if v},
           "card": smi}
    return clouds, launches_sel, rec, first


def schedule_path(label, env, kernel, make, evaluate, runs, smi,
                  order=("on", "off", "off", "on"), check_on=None):
    """``_turns`` with ``env`` set ("on") and its variables unset ("off"):
    ``kernel`` launches in every "on" turn and in no "off" turn, and
    ``check_on(launches)`` holds for the "on" turns. Returns (last clouds,
    "on" launches of the first turn, the record to print, the first
    table)."""
    def check(mode, launches):
        if mode == "on" and launches[kernel] <= 0:
            raise AssertionError(f"{label} launched {kernel} no time")
        if mode == "off" and launches[kernel] != 0:
            raise AssertionError(f"{label} launched {kernel} with the "
                                 "knob unset")
        if mode == "on" and check_on is not None:
            check_on(launches)

    envs = {"on": env, "off": {v: None for v in env}}
    clouds, launches_of, turns, first = _turns(
        label, order, envs, make, evaluate, runs, check)
    on = launches_of["on"]
    rec = {"n_points": clouds[0].n + clouds[1].n, "runs": runs, "env": env,
           "turns": turns, "table_equal": True,
           "launches_on": {k: v for k, v in on.items() if v},
           "launches_off": {k: v for k, v in launches_of["off"].items() if v},
           "card": smi}
    return clouds, on, rec, first


def schedule_sweeps(a, b, label, refine_impl, oracle=None):
    """Each of the three sweeps under ``refine_impl`` (at the rung its
    ladder settled on) against the default schedule's, bit for bit on the
    valid rows, and (given ``oracle`` sweeps) 0 rows off them. Records the
    adaptive schedule's P3 tail of each sweep: the rows it ran and their
    slot counts beyond the refined prefix. Returns {sweep: record}."""
    from open_pcc_metric_tpu_torch.ops import nn_pruned as nn_mod

    out = {}
    real = nn_mod.adaptive_refine
    for name, q, s, ex in _sweeps(a, b):
        calls = []

        def spy(*args, **kw):
            calls.append(args[3])  # ncand
            return real(*args, **kw)

        i0, d0 = pruned_search(q, s, ex)
        nn_mod.adaptive_refine = spy
        try:
            i1, d1 = pruned_search(q, s, ex, refine_impl=refine_impl)
        finally:
            nn_mod.adaptive_refine = real
        if not (_bit_equal(i0[: q.n], i1[: q.n])
                and _bit_equal(d0[: q.n], d1[: q.n])):
            raise AssertionError(f"{label} sweep {name}: {refine_impl} "
                                 "differs from the default schedule")
        rec = {"k7_launches": len(calls)}
        if len(calls) == 3:
            tail = calls[2]
            rec["p3_tiles"] = int((tail > 0).sum())
            rec["p3_slots_beyond_cap"] = sorted(
                (int(x) for x in tail[tail > 0]), reverse=True)
        if oracle is not None:
            oi, od = oracle[name]
            rec["rows_off_oracle"] = int(np.sum(
                (oi != i1[: q.n].cpu().numpy())
                | (od != d1[: q.n].double().cpu().numpy())))
            if rec["rows_off_oracle"]:
                raise AssertionError(f"{label} sweep {name} under "
                                     f"{refine_impl}: rows off the oracle")
        out[name] = rec
    return out


def payload_sweeps(a, b, label, oracle):
    """The two cross sweeps of the payload schedule (at the rung its ladder
    settled on) against the default schedule's, bit for bit on the valid
    rows, 0 rows off the ``oracle`` sweeps, and the payload equal to the
    gather at the id. Returns {sweep: rows off the oracle}."""
    import torch

    from open_pcc_metric_tpu_torch.ops.fused import _pack_payload
    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        nn_pruned_sorted_payload, unsort_nn_result, unsort_rows)

    off = {}
    for name, q, s, _ in _sweeps(a, b)[:2]:
        cap, ft = _settled_rung(q, s, "default", True)
        gq, gs = q.get_grid(), s.get_grid()
        pay_o = _pack_payload(s.points, s.colors, s.normals)
        d_s, i_s, p_s, ov = nn_pruned_sorted_payload(
            gq, gs, pay_o[gs.perm.long()], pay_o, q.n, cap=cap,
            fallback_tiles=ft)
        if bool(ov):
            raise AssertionError(f"{label} payload sweep {name} overflowed")
        d1, i1 = unsort_nn_result(gq, gs, d_s, i_s)
        pay = unsort_rows(gq, p_s)
        i0, d0 = pruned_search(q, s, False)
        if not (_bit_equal(i0[: q.n], i1[: q.n])
                and _bit_equal(d0[: q.n], d1[: q.n])):
            raise AssertionError(f"{label} payload sweep {name} differs from "
                                 "the default schedule")
        if not torch.equal(pay[: q.n], pay_o[i1[: q.n].long()]):
            raise AssertionError(f"{label} payload sweep {name}: the payload "
                                 "is not the gather at the id")
        oi, od = oracle[name]
        off[name] = int(np.sum((oi != i1[: q.n].cpu().numpy())
                               | (od != d1[: q.n].double().cpu().numpy())))
        if off[name]:
            raise AssertionError(f"{label} payload sweep {name}: rows off "
                                 "the oracle")
    return off


def _calls(names, sweep, module=None):
    """Run ``sweep`` once with every call of the kernel wrappers ``names``
    (as ``module``, by default ops/nn_pruned.py, calls them) recorded;
    returns {name: [(args, kwargs) of each call]}."""
    from open_pcc_metric_tpu_torch.ops import nn_pruned

    module = module or nn_pruned
    calls = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def spy(name):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return call

    for name in names:
        setattr(module, name, spy(name))
    try:
        sweep()
    finally:
        for name in names:
            setattr(module, name, real[name])
    return calls


def _replays(names, sweep, module=None):
    """``_calls``, each call as a function that replays it alone."""
    from open_pcc_metric_tpu_torch.ops import nn_pruned

    real = {name: getattr(module or nn_pruned, name) for name in names}
    return {name: [lambda x=x, kw=kw, f=real[name]: f(*x, **kw)
                   for x, kw in calls]
            for name, calls in _calls(names, sweep, module).items()}


# The passes of the counted schedules, in the order they call K1 or K3,
# and the moments passes of the counted k-NN, in the order they call K4.
PASSES = ("probe", "extension", "tier A", "tier B")
MOMENT_PASSES = ("stage 1", "tier A", "tier B")


def _passes(calls):
    """{pass name: (args, kwargs)} of a counted sweep's K1 or K3 calls."""
    if len(calls) > len(PASSES):
        raise AssertionError(f"{len(calls)} refine calls in one sweep")
    return dict(zip(PASSES, calls))


def _split_of(call):
    """(split count, blocks) of a K1, K3 or K4 call at the automatic
    count."""
    from open_pcc_metric_tpu_torch.ops.refine import sm_count, split_count

    cand = call[0][3]
    nt, w = cand.shape
    splits = split_count(nt, w, sm_count(cand.device))
    return splits, nt * splits


def stage_split(a, b, smi, ab):
    """Per sweep of the pair and per prologue: the sweep's stream time, the
    prologue's (``ab``, from ``prologue_ab``), the time of its K1 launches
    replayed alone, and the rest. CUDA events, mean of 5."""
    from open_pcc_metric_tpu_torch.ops.nn_pruned import nn_pruned_sorted

    cap, ft = _settled_rung(a, b)
    out = {}
    for name, q, s, ex in _sweeps(a, b):
        gq, gs = q.get_grid(), s.get_grid()
        for prologue in ("xla", "select"):
            def sweep():
                return nn_pruned_sorted(gq, gs, q.n, exclude_self=ex, cap=cap,
                                        fallback_tiles=ft, prologue=prologue)

            k1_calls = _replays(["refine_nn"], sweep)["refine_nn"]
            total = _time_ms(sweep, 5)
            k1 = _time_ms(lambda: [f() for f in k1_calls], 5)
            pro = ab[name][f"{prologue}_ms"]
            out[f"{name} {prologue}"] = {
                "sweep_ms": total, "prologue_ms": pro, "k1_ms": k1,
                "k1_launches": len(k1_calls), "rest_ms": total - pro - k1}
            del k1_calls
    print("2M stage split " + json.dumps({"rung": [cap, ft], "sweeps": out,
                                          "card": smi}), flush=True)
    return out


def schedule_split(a, b, label, smi, payload=True):
    """Per sweep of the pair at the rung each schedule's ladder settled on:
    the sweep's stream time under the default schedule with its K1 launches
    replayed alone (each pass named, with its split count); under the
    adaptive one with each K7 pass (P1, P2, P3)
    replayed alone; and, with ``payload``, the cross sweeps under the
    payload schedule with K6 (stage 1) and K1 (stage 2) replayed alone.
    The rest is the difference. CUDA events, mean of 5."""
    from open_pcc_metric_tpu_torch.ops import nn_pruned
    from open_pcc_metric_tpu_torch.ops.fused import _pack_payload
    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        nn_pruned_sorted, nn_pruned_sorted_payload)

    out = {}
    for name, q, s, ex in _sweeps(a, b):
        gq, gs = q.get_grid(), s.get_grid()
        rungs = {"default": _settled_rung(q, s),
                 "adaptive": _settled_rung(q, s, "adaptive")}
        for impl, kernel in (("default", "refine_nn"),
                             ("adaptive", "adaptive_refine")):
            cap, ft = rungs[impl]

            def sweep():
                return nn_pruned_sorted(gq, gs, q.n, exclude_self=ex, cap=cap,
                                        fallback_tiles=ft, refine_impl=impl,
                                        mxu_ok=True)

            calls = _calls([kernel], sweep)[kernel]
            total = _time_ms(sweep, 5)
            real = getattr(nn_pruned, kernel)
            ms = [_time_ms(lambda x=x, kw=kw: real(*x, **kw), 5)
                  for x, kw in calls]
            rec = {"rung": [cap, ft], "sweep_ms": total, f"{kernel}_ms": ms,
                   "rest_ms": total - sum(ms)}
            if impl == "default":  # each K1 pass and its split count
                rec["k1_passes_ms"] = dict(zip(PASSES, ms))
                rec["k1_splits"] = {p: _split_of(call)[0]
                                    for p, call in _passes(calls).items()}
            out[f"{name} {impl}"] = rec
            del calls
        if payload and not ex:
            cap, ft = _settled_rung(q, s, "default", True)
            pay_o = _pack_payload(s.points, s.colors, s.normals)
            pay_s = pay_o[gs.perm.long()]

            def sweep():
                return nn_pruned_sorted_payload(gq, gs, pay_s, pay_o, q.n,
                                                cap=cap, fallback_tiles=ft)

            replays = _replays(["refine_nn_payload", "refine_nn"], sweep)
            total = _time_ms(sweep, 5)
            k6 = _time_ms(lambda: [f() for f in replays["refine_nn_payload"]],
                          5)
            k1 = _time_ms(lambda: [f() for f in replays["refine_nn"]], 5)
            out[f"{name} payload"] = {"rung": [cap, ft], "sweep_ms": total,
                                      "k6_ms": k6, "k1_ms": k1,
                                      "rest_ms": total - k6 - k1}
    print(f"{label} schedule split " + json.dumps({"sweeps": out,
                                                    "card": smi}), flush=True)
    return out


def float_adaptive_line(forigin, reconst, dev, evaluate, smi):
    """One call on a float pair (the origin jittered off the lattice, so it
    fails Cloud.mxu_exact) with the default schedule and one under
    PCC_REFINE_IMPL=adaptive, fresh clouds each: the adaptive call takes
    the default schedule (K7 launched no time, K1 did) and the same table."""
    out = {}
    for mode, env in (("default", {"PCC_REFINE_IMPL": None}),
                      ("adaptive", ADAPTIVE_ENV)):
        with _env(env):
            (a, b), result, first_s, _, launches = _timed_runs(
                lambda: _pair_clouds(forigin, reconst, dev), evaluate, 0)
        out[mode] = (result, first_s, launches)
    result, first_s, launches = out["adaptive"]
    if a.mxu_exact() or not b.mxu_exact():
        raise AssertionError("the float pair's gate is not (False, True)")
    if launches["adaptive_refine"] or launches["refine_nn"] <= 0:
        raise AssertionError("the float pair under adaptive launched K7")
    if any(not np.array_equal(np.asarray(result[k]),
                              np.asarray(out["default"][0][k]))
           for k in result):
        raise AssertionError("the float pair's adaptive table differs")
    print("float pair under adaptive " + json.dumps({
        "n_points": a.n + b.n, "mxu_exact": [a.mxu_exact(), b.mxu_exact()],
        "first_call_s": {m: v[1] for m, v in out.items()},
        "launches": {m: {k: n for k, n in v[2].items() if n}
                     for m, v in out.items()},
        "table_equal": True, "card": smi}), flush=True)


def fixed_table(gq, gs, nq, cap):
    """The fixed schedule's stage-1 inputs of one sweep: (valid_t, lb, the
    kernel K2c's ``cap`` candidates)."""
    from open_pcc_metric_tpu_torch.ops.grid import bbox_lower_bounds
    from open_pcc_metric_tpu_torch.ops.nn_pruned import tile_boxes
    from open_pcc_metric_tpu_torch.ops.refine import select_candidates

    valid_t, a_lo, a_hi = tile_boxes(gq, nq)
    lb = bbox_lower_bounds(a_lo, a_hi, gs.bbox_lo, gs.bbox_hi)
    return valid_t, lb, select_candidates(lb, min(cap, gs.n_chunks))


def k2c_phases(cases):
    """K2c against its plain version on the card, on the lb matrix of each
    case (name, query grid, search grid, valid queries, cap): picks
    bit-identical on every row, and equal to the stable sort's prefix
    (``lb_order``) on every tile with a valid query; the first design
    (``rounds=True``, its time ``rounds_ms``) gives the same picks.
    Library: ``torch.sort(lb, dim=1, stable=True).indices[:, :cap]`` on the
    same matrix. Bound: nta * ncb compares at the float32 rate against the
    matrix read once and the picks written once."""
    import torch

    from open_pcc_metric_tpu_torch.ops.nn_pruned import lb_order
    from open_pcc_metric_tpu_torch.ops.refine import (
        select_candidates, select_candidates_reference)

    recs = []
    for name, gq, gs, nq, cap in cases:
        valid_t, lb, got = fixed_table(gq, gs, nq, cap)
        cap = got.shape[1]
        torch.cuda.synchronize()
        want, plain_ms = _once_ms(lambda: select_candidates_reference(lb, cap))
        if not _bit_equal(got, want):
            raise AssertionError(f"K2c phase {name}: {int((got != want).sum())}"
                                 " picks differ from the plain version")
        live = valid_t.any(dim=1)
        if not _bit_equal(got[live], lb_order(lb[live])[:, :cap]):
            raise AssertionError(f"K2c phase {name}: a valid tile's picks are "
                                 "not its stable order's prefix")
        if not _bit_equal(select_candidates(lb, cap, rounds=True), want):
            raise AssertionError(f"K2c phase {name}: the first design's "
                                 "picks differ from the plain version")
        nta, ncb = lb.shape
        bound_ms, bound_by = _bound(OPS_PICK * nta * ncb, [lb], [got])
        rec = {
            "phase": name, "tiles": nta, "chunks": ncb, "cap": cap,
            "empty_tiles": int((~live).sum()), "max_abs_err": 0.0,
            "ms": _time_ms(lambda: select_candidates(lb, cap), 20),
            "rounds_ms": _time_ms(
                lambda: select_candidates(lb, cap, rounds=True), 10),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _time_ms(lambda: torch.sort(
                lb, dim=1, stable=True).indices[:, :cap], 10),
        }
        rec["at_or_below_sort"] = rec["ms"] <= rec["library_ms"]
        print("kernel phase K2c " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def straight_phases(cases):
    """K1b and K1c against their plain version and K1 ungated on the card,
    on the fixed schedule's stage-1 table of each case (name, query grid,
    search grid, valid queries, exclude_self; cap CAP): d and id
    bit-identical on every row, K1b and K1c also at one block a tile, the
    times printed. Both bounds count what the word skip cannot avoid
    (``_skip_ops`` against each row's final d) and the bytes the call reads
    (``_refine_bytes``), with the all-pairs bound beside them, the split,
    registers and blocks an SM, and K1c's chunks a step (``ASYNC_DEPTH``).
    Returns (K1b records, K1c records)."""
    import torch

    from open_pcc_metric_tpu_torch.ops.refine import (
        ASYNC_DEPTH, occupancy, refine_nn, refine_nn_fused,
        refine_nn_straight, refine_nn_straight_reference, sm_count,
        split_count)

    occ = {fn: occupancy(fn.__name__)
           for fn in (refine_nn_straight, refine_nn_fused)}
    k1b, k1c = [], []
    for name, gq, gs, nq, ex in cases:
        cand = fixed_table(gq, gs, nq, CAP)[2]
        args = (gq.points, gs.points, gs.perm, cand)
        outs = {fn.__name__: fn(*args, exclude_self=ex) for fn in (
            refine_nn_straight, refine_nn_fused, refine_nn)}
        for fn in (refine_nn_straight, refine_nn_fused):
            outs[fn.__name__ + " splits=1"] = fn(*args, exclude_self=ex,
                                                 splits=1)
        torch.cuda.synchronize()
        want, plain_ms = _once_ms(
            lambda: refine_nn_straight_reference(*args, exclude_self=ex))
        for fn_name, got in outs.items():
            if not all(_bit_equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"straight phase {name}: {fn_name} "
                                     "differs from the plain version")
        nbytes = _refine_bytes(*args, None, None, None, want)
        all_pairs = _bound_of(OPS_PER_PAIR * _live_pairs(cand, None), nbytes)
        bound_ms, bound_by = _bound_of(
            _skip_ops(gq.points, gs.points, cand, None, None, want[0]),
            nbytes)
        ms = {fn.__name__: _time_ms(lambda fn=fn: fn(*args, exclude_self=ex),
                                    20)
              for fn in (refine_nn_straight, refine_nn_fused, refine_nn)}
        nt, w = cand.shape
        for label, fn, recs in (("K1b", refine_nn_straight, k1b),
                                ("K1c", refine_nn_fused, k1c)):
            regs, per_sm = occ[fn]
            rec = {
                "phase": name, "tiles": nt, "slots": w,
                "compared": "every row, with the plain version and K1 ungated",
                "max_abs_err": 0.0, "ms": ms[fn.__name__],
                "plain_ms": plain_ms,
                "k1b_ms": ms["refine_nn_straight"],
                "k1c_ms": ms["refine_nn_fused"], "k1_ms": ms["refine_nn"],
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "splits": split_count(nt, w, sm_count(cand.device)),
                "ms_splits_1": _time_ms(lambda fn=fn: fn(
                    *args, exclude_self=ex, splits=1), 20),
                "bound_all_pairs_ms": all_pairs[0],
                "registers": regs, "blocks_per_sm": per_sm,
            }
            if label == "K1c":
                rec["chunks_a_step"] = ASYNC_DEPTH
            print(f"kernel phase {label} " + json.dumps(rec), flush=True)
            recs.append(rec)
    return k1b, k1c


def knn_straight_phases(cases):
    """K3b against its plain version and K3 ungated on the card, on the
    fixed schedule's stage-1 table of each case (name, grid, valid queries;
    self 30-NN, cap KCAP): d and id bit-identical to K3 and to K3b without
    its slot skip on every row, and to the plain version on the tiles with
    a valid query (K2c repeats chunk 0 on the others, where the kernels
    keep repeated points and the plain version does not). ``ms`` is K3b as
    the schedule calls it (with the chunk boxes), ``ms_no_slot_skip``
    without; both kernels' registers and blocks an SM (CUDA runtime).
    Bound: the operations the word and slot skips cannot avoid on this
    data (``_skip_ops``) and the bytes the call reads."""
    import torch

    from open_pcc_metric_tpu_torch.ops.refine import (
        occupancy, refine_knn, refine_knn_straight,
        refine_knn_straight_reference)

    recs = []
    occ = {n: occupancy(n) for n in ("refine_knn_straight", "refine_knn")}
    for name, g, n in cases:
        valid_t, _, cand = fixed_table(g, g, n, KCAP)
        args = (g.points, g.points, g.perm, cand, K)
        boxes = (g.bbox_lo, g.bbox_hi)
        got = refine_knn_straight(*args, boxes=boxes)
        unskipped = refine_knn_straight(*args)
        k3 = refine_knn(*args)
        torch.cuda.synchronize()
        if not all(_bit_equal(x, y) and _bit_equal(x, z)
                   for x, y, z in zip(got, k3, unskipped)):
            raise AssertionError(f"K3b phase {name}: differs from K3 ungated "
                                 "or from K3b without the slot skip")
        tiles = valid_t.any(dim=1).nonzero()[:, 0]
        sub = cand[tiles].contiguous()
        want, plain_ms = _once_ms(lambda: refine_knn_straight_reference(
            g.points, g.points, g.perm, sub, K, tiles=tiles.to(torch.int32)))
        if not all(_bit_equal(x[tiles], y) for x, y in zip(got, want)):
            raise AssertionError(f"K3b phase {name}: valid tiles differ from "
                                 "the plain version")
        bound_ms, bound_by = _bound_of(
            _skip_ops(g.points, g.points, cand, None, None, got[0][..., -1],
                      chunk_boxes=boxes),
            _refine_bytes(*args[:4], None, None, None, got))
        rec = {
            "phase": name, "tiles": int(cand.shape[0]),
            "slots": int(cand.shape[1]),
            "compared": (f"every row with K3 ungated and without the slot "
                         f"skip; the {len(tiles)} tiles with a valid query "
                         "with the plain version"),
            "plain_tiles": int(len(tiles)), "max_abs_err": 0.0,
            "ms": _time_ms(lambda: refine_knn_straight(*args, boxes=boxes),
                           5),
            "ms_no_slot_skip": _time_ms(lambda: refine_knn_straight(*args), 5),
            "k3_ms": _time_ms(lambda: refine_knn(*args), 5),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "registers": occ["refine_knn_straight"][0],
            "blocks_per_sm": occ["refine_knn_straight"][1],
            "k3_registers": occ["refine_knn"][0],
            "k3_blocks_per_sm": occ["refine_knn"][1],
        }
        print("kernel phase K3b " + json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def fixed_sweeps(a, b, oracle):
    """Each of the three sweeps under the fixed schedule (at the rung the
    ladder settled on) against the counted schedule's, bit for bit on the
    valid rows, and 0 rows off the ``oracle`` sweeps. Returns {sweep: rows
    off the oracle}."""
    off = {}
    for name, q, s, ex in _sweeps(a, b):
        i0, d0 = pruned_search(q, s, ex)
        i1, d1 = pruned_search(q, s, ex, sched="fixed")
        if not (_bit_equal(i0[: q.n], i1[: q.n])
                and _bit_equal(d0[: q.n], d1[: q.n])):
            raise AssertionError(f"fixed sweep {name} differs from the "
                                 "counted schedule")
        oi, od = oracle[name]
        off[name] = int(np.sum((oi != i1[: q.n].cpu().numpy())
                               | (od != d1[: q.n].double().cpu().numpy())))
        if off[name]:
            raise AssertionError(f"fixed sweep {name}: rows off the oracle")
    return off


def fixed_split(a, b, smi):
    """Per sweep of the 800k pair at the settled rung: the sweep's stream
    time under the fixed schedule with K2c, K1b and the K1 tiers replayed
    alone, and under the counted schedule with its prologue
    (``tile_bounds``: the lb matrix and its full stable sort), the K1 probe
    and extension, and the K1 tiers replayed alone. The rest is the
    difference. CUDA events, mean of 5."""
    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        nn_pruned_sorted, tile_bounds)

    cap, ft = _settled_rung(a, b)
    out = {}
    for name, q, s, ex in _sweeps(a, b):
        gq, gs = q.get_grid(), s.get_grid()
        rec = {}
        for sched in ("fixed", "counted"):
            def sweep():
                return nn_pruned_sorted(gq, gs, q.n, exclude_self=ex, cap=cap,
                                        fallback_tiles=ft, sched=sched)

            names = ["refine_nn"] + (["select_candidates", "refine_nn_straight"]
                                     if sched == "fixed" else [])
            replays = _replays(names, sweep)
            total = _time_ms(sweep, 5)
            k1 = replays["refine_nn"]
            if sched == "fixed":
                parts = {
                    "k2c_ms": _time_ms(replays["select_candidates"][0], 5),
                    "k1b_ms": _time_ms(replays["refine_nn_straight"][0], 5),
                    "tiers_ms": _time_ms(lambda: [f() for f in k1], 5)}
            else:
                parts = {
                    "prologue_ms": _time_ms(
                        lambda: tile_bounds(gq, gs, q.n), 5),
                    "probe_extension_ms": _time_ms(
                        lambda: [f() for f in k1[:2]], 5),
                    "tiers_ms": _time_ms(lambda: [f() for f in k1[2:]], 5)}
            rec[sched] = {"sweep_ms": total, **parts,
                          "rest_ms": total - sum(parts.values())}
            del replays, k1
        out[name] = rec
    print("800k fixed schedule split " + json.dumps(
        {"rung": [cap, ft], "sweeps": out, "card": smi}), flush=True)
    return out


def _journal_metrics(metrics):
    """A fused_evaluate result as run_sweep writes it into the journal."""
    return {k: (v.tolist() if hasattr(v, "tolist") else float(v))
            for k, v in metrics.items()}


def _wide_cloud(raw, pad_to, dev):
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud

    return Cloud.from_numpy(raw.points, raw.colors, raw.normals,
                            torch.float32, pad_to, False, device=dev)


def _per_pair_misses(common, per_pair):
    """Entries of the per-pair sweep off the common one: PSNRs by more
    than PSNR_TOL dB, others by more than PER_PAIR_RTOL relative. Returns
    ({"tag key": deviation}, the largest PSNR and relative deviations)."""
    misses, worst_psnr, worst_rel = {}, 0.0, 0.0
    for c, p in zip(common, per_pair):
        for k, v in c["metrics"].items():
            w = np.asarray(v, np.float64)
            g = np.asarray(p["metrics"][k], np.float64)
            if np.array_equal(g, w):
                continue
            if "psnr" in k:
                dev = float(np.max(np.abs(g - w)))
                worst_psnr = max(worst_psnr, dev)
                bad = dev > PSNR_TOL
            else:
                dev = float(np.max(np.abs(g - w) / np.maximum(
                    np.abs(w), np.finfo(np.float64).tiny)))
                worst_rel = max(worst_rel, dev)
                bad = dev > PER_PAIR_RTOL
            if bad:
                misses[f"{c['tag']} {k}"] = dev
    return misses, worst_psnr, worst_rel


def _qp04_oracle(ref_raw, deg_raw, deg, metrics):
    """The qp04 pair's PSNRs against a float64 evaluation: scipy oracle
    sweeps, the reference's file normals and float64 LAPACK normals of the
    degraded cloud's oracle 30-NN sets; D2 entries within D2_TOL, the
    others within PSNR_TOL.

    The degraded points are multiples of 2^(4/6), not integers, and a
    float32 cloud holds them rounded to float32: that moves their squared
    distances and reorders neighbours that the lattice makes equidistant,
    so the 30-NN sets of the float64 coordinates are not the float32
    cloud's. The oracle therefore evaluates, in float64, the coordinates
    the cloud holds (``float32_points``, held to the bars); the same
    evaluation of the float64 file coordinates is reported beside it
    (``float64_points``), each with the rows whose 30-NN set differs from
    the port's (``knn_sets_differ``)."""
    import bench
    from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned

    idx, _ = knn_pruned(deg.points, deg.points, deg.n, deg.n, k=K,
                        cap=KCAP, fallback_tiles=KFT)
    port_sets = np.sort(idx[: deg.n].cpu().numpy(), axis=1)
    out = {}
    for label, held in (("float32_points", True), ("float64_points", False)):
        opts = ref_raw.points
        pts = deg_raw.points
        if held:
            opts = opts.astype(np.float32).astype(np.float64)
            pts = pts.astype(np.float32).astype(np.float64)
        origin = (opts, ref_raw.colors, ref_raw.normals)
        oi, _ = bench._oracle_knn_fast(pts, pts, K)
        neigh = pts[oi]
        cen = neigh - neigh.mean(axis=1, keepdims=True)
        cov = np.einsum("nki,nkj->nij", cen, cen) / K
        reconst = (pts, deg_raw.colors, np.linalg.eigh(cov)[1][:, :, 0])
        sweeps = {
            "a->b": bench._oracle_nn_fast(opts, pts),
            "b->a": bench._oracle_nn_fast(pts, opts),
            "self a->a": bench._oracle_nn_fast(opts, opts,
                                               exclude_self=True)}
        want = _want_psnrs(origin, reconst, sweeps, origin[2], reconst[2])
        deltas = _psnr_deltas(metrics, want)
        out[label] = {
            "knn_sets_differ": int(np.any(
                np.sort(oi, axis=1) != port_sets, axis=1).sum()),
            "max_dpsnr_d2": max(v for k, v in deltas.items()
                                if k.startswith("d2_")),
            "max_dpsnr_other": max(v for k, v in deltas.items()
                                   if not k.startswith("d2_")),
            "psnr_entries": len(want)}
    held = out["float32_points"]
    if not (held["max_dpsnr_d2"] <= D2_TOL
            and held["max_dpsnr_other"] <= PSNR_TOL):
        raise AssertionError(f"sweep qp04 vs the float64 oracle: {out}")
    return out


def upload_ab(raw, pad_to, dev, smi):
    """Cloud.from_numpy onto the card, thin against wide, in turns: the
    median of UPLOAD_RUNS calls each, every call ended by a synchronise;
    the two clouds' tensors bit-identical."""
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud

    args = (raw.points, raw.colors, raw.normals, torch.float32, pad_to)
    times = {True: [], False: []}
    clouds = {}
    for i in range(2 * UPLOAD_RUNS):
        thin = (i % 4) in (0, 3)  # thin, wide, wide, thin, ...
        t0 = time.perf_counter()
        clouds[thin] = Cloud.from_numpy(*args, thin, device=dev)
        torch.cuda.synchronize()
        times[thin].append(time.perf_counter() - t0)
    for name in ("points", "colors", "normals"):
        if not _bit_equal(getattr(clouds[True], name),
                          getattr(clouds[False], name)):
            raise AssertionError(f"the thin upload's {name} differ from the "
                                 "wide upload's")
    rows = clouds[True].padded_size
    rec = {"n_points": clouds[True].n, "padded_rows": rows,
           "thin_bytes": rows * (6 + 3 + 12), "wide_bytes": rows * 36,
           "thin_ms": [t * 1e3 for t in times[True]],
           "wide_ms": [t * 1e3 for t in times[False]],
           "thin_median_ms": statistics.median(times[True]) * 1e3,
           "wide_median_ms": statistics.median(times[False]) * 1e3,
           "bit_identical": True, "card": smi}
    print("thin upload 800k " + json.dumps(rec), flush=True)
    return rec


def sweep_path(dev, smi, n_points=N_POINTS):
    """The QP-sweep workflow (examples/qp_sweep.py) through the port:
    datasets.write_qp_sweep's reference with normals and six degraded
    frames without, run_sweep over them (ycc, point-to-plane, pc_error),
    the launch counts set to 0 just before and read just after. Checks:
    no error record, K1, K3 and K4 launched; every record bit-equal to a
    fresh fused_evaluate of the same files loaded wide at the same pad;
    qp04 against the float64 oracle; a resumed sweep evaluates nothing
    and returns the same records; pad="per-pair" against pad="common";
    the CLI's journal equal to run_sweep's; the thin upload bit-equal to
    the wide one."""
    import tempfile

    from open_pcc_metric_tpu_torch import datasets
    from open_pcc_metric_tpu_torch.batch import SweepItem, run_sweep
    from open_pcc_metric_tpu_torch.cloud import pad_bucket
    from open_pcc_metric_tpu_torch.io import point_count, read_point_cloud
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    with tempfile.TemporaryDirectory(prefix="pcc_sweep_") as tmp:
        t0 = time.perf_counter()
        ref, degraded = datasets.write_qp_sweep(tmp, n_points=n_points)
        items = [SweepItem(ref, p, f"qp{qp:02d}") for qp, p in degraded]
        pad_to = pad_bucket(max(point_count(p) for p in
                                [ref] + [p for _, p in degraded]))
        print("sweep data " + json.dumps({
            "reference_points": point_count(ref),
            "degraded_points": {it.tag: point_count(it.pcloud)
                                for it in items},
            "pad_to": pad_to, "write_s": time.perf_counter() - t0}),
            flush=True)

        journal = os.path.join(tmp, "sweep.jsonl")
        restore = _guarded(_plain_names())
        try:
            _reset_launches()
            t0 = time.perf_counter()
            records = run_sweep(items, journal, device=dev, **SWEEP_KW)
            sweep_s = time.perf_counter() - t0
            launches = _launches()
        finally:
            restore()
        errors = {r["tag"]: r["error"] for r in records if "error" in r}
        if errors:
            raise AssertionError(f"the sweep wrote error records: {errors}")
        for name in ("refine_nn", "refine_knn", "knn_moments"):
            if launches[name] <= 0:
                raise AssertionError(f"the sweep launched {name} no time")
        stages = {s: statistics.median(r["stages"][s] for r in records[1:])
                  for s in ("parse_s", "upload_s", "load_wait_s", "eval_s")}
        print("sweep path 800k " + json.dumps({
            "pairs": [{"tag": r["tag"], "wall_s": r["wall_s"],
                       "mpts_per_s": r["mpoints_per_sec"],
                       "stages": r["stages"]} for r in records],
            "sweep_s": sweep_s,
            "stage_medians_after_first": stages,
            "launches": {k: v for k, v in launches.items() if v},
            "card": smi}), flush=True)

        # Each record against a fresh evaluation of its files, loaded wide.
        ref_raw = read_point_cloud(ref)
        origin = _wide_cloud(ref_raw, pad_to, dev)
        checks = {}
        for rec in records:
            raw = read_point_cloud(rec["pcloud"])
            deg = _wide_cloud(raw, pad_to, dev)
            fresh = fused_evaluate(origin, deg, **SWEEP_KW)
            got = _journal_metrics(fresh)
            off = [k for k in got if got[k] != rec["metrics"][k]]
            if off:
                raise AssertionError(f"sweep {rec['tag']}: {off} differ from "
                                     "a fresh wide evaluation")
            if rec["tag"] == "qp04":
                checks["qp04_oracle"] = _qp04_oracle(ref_raw, raw, deg,
                                                     fresh)
        checks["records_equal_fresh_wide_loads"] = len(records)
        del origin, deg

        _reset_launches()
        t0 = time.perf_counter()
        resumed = run_sweep(items, journal, device=dev, **SWEEP_KW)
        checks["resume_s"] = time.perf_counter() - t0
        if resumed != records or any(_launches().values()):
            raise AssertionError("the resumed sweep evaluated a frame or "
                                 "returned other records")
        checks["resume_evaluates_nothing"] = True

        per_pair = run_sweep(items, os.path.join(tmp, "per_pair.jsonl"),
                             pad="per-pair", device=dev, **SWEEP_KW)
        misses, worst_psnr, worst_rel = _per_pair_misses(records, per_pair)
        checks["per_pair_vs_common"] = {
            "max_dpsnr": worst_psnr, "max_rel": worst_rel, "misses": misses}
        if misses:
            print("sweep checks " + json.dumps(checks), flush=True)
            raise AssertionError(f"pad='per-pair' misses pad='common': "
                                 f"{misses}")

        manifest = os.path.join(tmp, "manifest.csv")
        with open(manifest, "w") as f:
            f.write("".join(f"{it.ocloud},{it.pcloud},{it.tag}\n"
                            for it in items))
        cli_journal = os.path.join(tmp, "cli.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "open_pcc_metric_tpu_torch.batch",
             "--manifest", manifest, "--journal", cli_journal, "--color",
             "ycc", "--point-to-plane", "--d2-mode", "pc_error",
             "--device", dev.type],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the sweep CLI failed: {proc.stderr[-3000:]}")
        last = proc.stdout.strip().splitlines()[-1]
        if last != f"{len(items)}/{len(items)} frames evaluated -> " \
                   f"{cli_journal}":
            raise AssertionError(f"the sweep CLI printed {last!r}")
        with open(cli_journal) as f:
            cli = [json.loads(line) for line in f]
        if [r["metrics"] for r in cli] != [r["metrics"] for r in records]:
            raise AssertionError("the CLI's journal differs from run_sweep's")
        checks["cli_journal_equal"] = True
        checks["cli_s"] = time.perf_counter() - t0
        checks["card"] = smi
        print("sweep checks " + json.dumps(checks), flush=True)
        upload = upload_ab(ref_raw, pad_to, dev, smi)
        sharded = sharded_sweep(items, records, tmp, dev, smi)
    return records, launches, upload, sharded


def sharded_sweep(items, records, tmp, dev, smi):
    """run_sweep_sharded over the QP sweep's files on a (2, 1) mesh of
    cuda:0 slots (two frames a group), the launch counts set to 0 just
    before and read just after, every plain version guarded. Each record
    against run_sweep's on the same files: PSNRs within PSNR_TOL dB,
    min_sqrt and max_sqrt equal. Returns the line's record."""
    from open_pcc_metric_tpu_torch.batch import run_sweep_sharded
    from open_pcc_metric_tpu_torch.parallel import sharded
    from open_pcc_metric_tpu_torch.parallel.sharded import make_mesh

    mesh = make_mesh(devices=[dev] * 2, dp=2)
    restore = _guarded(_plain_names() + [(sharded, "refine_nn_reference")])
    try:
        _reset_launches()
        t0 = time.perf_counter()
        got = run_sweep_sharded(items, os.path.join(tmp, "sharded.jsonl"),
                                mesh=mesh, **SWEEP_KW)
        sweep_s = time.perf_counter() - t0
        launches = _launches()
    finally:
        restore()
    if launches["refine_nn"] <= 0:
        raise AssertionError("the sharded sweep launched K1 no time")
    want = {r["tag"]: r["metrics"] for r in records}
    worst = 0.0
    for rec in got:
        m = want[rec["tag"]]
        for k, v in rec["metrics"].items():
            if "psnr" in k:
                dev_db = float(np.max(np.abs(np.asarray(v, np.float64)
                                             - np.asarray(m[k], np.float64))))
                worst = max(worst, dev_db)
                if not dev_db <= PSNR_TOL:
                    raise AssertionError(f"sharded sweep {rec['tag']} {k} "
                                         f"off run_sweep by {dev_db} dB")
        for k in ("min_sqrt", "max_sqrt"):
            if rec["metrics"][k] != m[k]:
                raise AssertionError(f"sharded sweep {rec['tag']} {k} "
                                     "differs from run_sweep's")
    out = {"mesh": list(mesh.devices.shape), "sweep_s": sweep_s,
           "groups": [{"tags": [r["tag"] for r in got[g:g + 2]],
                       "wall_s": got[g]["wall_s"],
                       "group_mpts_per_s": got[g]["group_mpoints_per_sec"]}
                      for g in range(0, len(got), 2)],
           "max_dpsnr_vs_run_sweep": worst,
           "launches": {k: v for k, v in launches.items() if v},
           "card": smi}
    print("sharded sweep 800k " + json.dumps(out), flush=True)
    return out


def _max_rel(stats, single):
    """The largest relative difference of the ring's stats (frame 0) from
    the single-device pair_stats (bench.py's measure)."""
    worst = 0.0
    for key, val in single.items():
        if key == "nn_overflow":
            continue
        got = np.asarray(stats[key][0].cpu(), np.float64).reshape(-1)
        want = np.asarray(val.cpu() if hasattr(val, "cpu") else val,
                          np.float64).reshape(-1)
        scale = np.maximum(np.abs(want), 1e-30)
        worst = max(worst, float(np.max(np.abs(got - want) / scale)))
    return worst


def _ring_cloud(arrays, pad, dev, normals=True):
    from open_pcc_metric_tpu_torch.cloud import Cloud

    pts, col, nrm = arrays
    return Cloud.from_numpy(pts, colors=col, normals=nrm if normals else None,
                            pad_to=pad, device=dev)


def _ring_pad(*clouds):
    """One common pad for the ring's clouds, divisible by RING_SLOTS x 256."""
    step = RING_SLOTS * 256
    return -(-max(c[0].shape[0] for c in clouds) // step) * step


def _plain_by_width(q, b, perm, cand, ncand, exclude_self):
    """``refine_nn_reference`` on one K1 call's inputs, its tiles grouped
    by live slot count: a group whose counts lie in (W/2, W] runs on the
    table's first W columns (a tile's slots past its count are gated off
    either way), so the plain version's work follows the call's live work,
    not its table's width. Returns (d, ids), (nt, 256) each."""
    import torch

    from open_pcc_metric_tpu_torch.ops import refine
    from open_pcc_metric_tpu_torch.ops.grid import CHUNK

    nt, w = cand.shape
    live = (torch.full((nt,), w, dtype=torch.int32, device=cand.device)
            if ncand is None else ncand)
    out_d = torch.empty((nt, CHUNK), dtype=q.dtype, device=q.device)
    out_i = torch.empty((nt, CHUNK), dtype=torch.int32, device=q.device)
    lo, width = -1, 1
    while lo < w:
        sel = torch.nonzero((live > lo) & (live <= width)).reshape(-1)
        if sel.numel():
            d, i = refine.refine_nn_reference(
                q, b, perm, cand[sel, :min(width, w)].contiguous(),
                tiles=sel.to(torch.int32), ncand=live[sel].contiguous(),
                exclude_self=exclude_self)
            out_d[sel], out_i[sel] = d, i
        lo, width = width, 2 * width
    return out_d, out_i


def _payload_at(pay, perm, ids):
    """Each original id's payload row: the row of ``pay`` whose id in
    ``perm`` it is, found by a sorted search (ids absent from ``perm``, the
    INT_MAX of a row nothing reached, take any row)."""
    import torch

    order = torch.argsort(perm.long())
    pos = torch.searchsorted(perm.long()[order], ids.long())
    return pay[order[pos.clamp(max=order.numel() - 1)]]


def ring_k1_calls(label, calls, q_slots, n_valid):
    """Each K1 call of one ring search (``_refine_local_pallas``'s
    arguments and results, captured) against the plain version on the same
    inputs: d, original ids and payload rows bit-identical on every valid
    query row (global row < ``n_valid``). Returns the line's fields: the
    calls, the gated ones whose table is partial (a tile with live slots
    below the table's width), the widest table, K1's device ms over the
    calls (replayed, mean of 3), the plain version's (once) and the sum of
    the calls' bounds (``_skip_ops`` against each call's final d,
    ``_refine_bytes``), with how many calls each side bounds."""
    import torch

    from open_pcc_metric_tpu_torch.ops import refine
    from open_pcc_metric_tpu_torch.ops.refine import INT_MAX

    def k1():
        for (q, b, perm, _, cand, ncand, _, excl), _ in calls:
            refine.refine_nn(q, b, perm, cand.contiguous(), ncand=ncand,
                             exclude_self=excl)

    plains, plain_ms = _once_ms(lambda: [
        _plain_by_width(q, b, perm, cand, ncand, excl)
        for (q, b, perm, _, cand, ncand, _, excl), _ in calls])
    k1_ms = _time_ms(k1, 3)
    pl_rows = q_slots[0].shape[0]
    partial = rows = 0
    for ((q, _, perm, pay, cand, ncand, _, _), (d, i, p)), (pd, pi) in zip(
            calls, plains):
        me = next(j for j, x in enumerate(q_slots) if x is q)
        valid = (me * pl_rows + torch.arange(pl_rows, device=q.device)
                 < n_valid)
        pd, pi = pd.reshape(-1), pi.reshape(-1)
        if not (_bit_equal(d[valid], pd[valid])
                and torch.equal(i[valid], pi[valid])):
            raise AssertionError(f"{label}: a K1 call of slot {me} differs "
                                 "from the plain version")
        won = valid & (pi != INT_MAX)
        if p is not None and not torch.equal(
                p[won], _payload_at(pay, perm, pi)[won]):
            raise AssertionError(f"{label}: a K1 call of slot {me} picked "
                                 "payload rows off the plain version's")
        if ncand is not None:
            partial += int(bool(((ncand > 0)
                                 & (ncand < cand.shape[1])).any()))
        rows += int(valid.sum())
    # Each call's bound: what its word skip cannot avoid against its rows'
    # final d, and the bytes it reads and writes once; summed over calls.
    bound_ms, bound_by = 0.0, {}
    for (q, b, perm, _, cand, ncand, _, _), (d, i, _) in calls:
        ms, by = _bound_of(
            _skip_ops(q, b, cand, None, ncand, d),
            _refine_bytes(q, b, perm, cand, None, ncand, None, (d, i)))
        bound_ms += ms
        bound_by[by] = bound_by.get(by, 0) + 1
    return {"k1_calls": len(calls), "partial_gated_calls": partial,
            "widest_table": max(c[0][4].shape[1] for c in calls),
            "valid_rows_compared": rows, "k1_ms": k1_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by_calls": bound_by}


def ring_path(origin, reconst, dev, smi):
    """The pruned ring (``sharded_pair_stats_pruned_auto``) on the 800k pair
    with normals, packed at one pad divisible by RING_SLOTS x 256, on a
    1-slot mesh (``make_mesh(1)``, bench.py's PCC_BENCH_SHARDED=1) and a
    RING_SLOTS-slot ring on cuda:0: one warm-up (the ladder settles) and
    RUNS timed calls each, every plain version guarded (and the ring's own
    binding of ``refine_nn_reference``), the launch counts set to 0 just before and read just after.
    Checks: every stat within RING_RTOL of the single-device pair_stats;
    ``ring_nn_pruned`` a->b at the settled cap, with b's colours, normals
    and points as payload, bit-identical in (d, original id) on every valid
    row to the single-device ``nn_pruned_sorted``, its payload rows b's at
    those ids, and each of its K1 calls bit-identical to the plain version
    on the same inputs (``ring_k1_calls``); K1 launched. Returns {mesh
    label: launches}."""
    import torch

    from open_pcc_metric_tpu_torch.ops.fused import pair_stats
    from open_pcc_metric_tpu_torch.ops.grid import CHUNK
    from open_pcc_metric_tpu_torch.ops.nn_pruned import nn_pruned_sorted
    from open_pcc_metric_tpu_torch.parallel import sharded
    from open_pcc_metric_tpu_torch.parallel.sharded import (
        make_mesh, pack_sorted_frames, sharded_pair_stats_pruned_auto)
    from open_pcc_metric_tpu_torch.utils.cache import climb

    pad = _ring_pad(origin, reconst)
    a, b = _ring_cloud(origin, pad, dev), _ring_cloud(reconst, pad, dev)
    ga, gb = a.get_grid(), b.get_grid()
    packed = pack_sorted_frames([a], [b], **SWEEP_KW)

    def single_run(cap, ft):
        st = pair_stats(a.points, b.points, a.n, b.n, a.colors, b.colors,
                        a.normals, b.normals, ga, gb, backend="pruned",
                        prune_cap=cap, prune_fallback=ft, **SWEEP_KW)
        return st, bool(st["nn_overflow"])

    def sweep_run(cap, ft):
        r = nn_pruned_sorted(ga, gb, a.n, cap=cap, fallback_tiles=ft)
        return r, bool(r[2])

    n_chunks = pad // CHUNK
    single, _ = climb(single_run, (CAP, FALLBACK), n_chunks, n_chunks)
    (want_d, want_i, _), _ = climb(sweep_run, (CAP, FALLBACK), n_chunks,
                                   n_chunks)
    pay_b = torch.cat([packed["b_col_s"][0], packed["b_nrm_s"][0],
                       packed["b_s"][0]], dim=1)
    n_total = a.n + b.n
    out = {}
    for label, mesh in (("1-slot", make_mesh(1)),
                        (f"{RING_SLOTS}-slot",
                         make_mesh(devices=[dev] * RING_SLOTS))):
        restore = _guarded(_plain_names() + [(sharded, "refine_nn_reference")])
        try:
            _reset_launches()
            t0 = time.perf_counter()
            stats = sharded_pair_stats_pruned_auto(mesh, packed, **SWEEP_KW)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            warm = _launches()["refine_nn"]
            times = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                stats = sharded_pair_stats_pruned_auto(mesh, packed,
                                                       **SWEEP_KW)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches = _launches()
        finally:
            restore()
        if launches["refine_nn"] <= 0:
            raise AssertionError(f"the {label} ring launched K1 no time")
        if bool(stats["nn_overflow"].any()):
            raise AssertionError(f"the {label} ring ended overflowed")
        worst = _max_rel(stats, single)
        if not worst <= RING_RTOL:
            raise AssertionError(f"the {label} ring's stats are off "
                                 f"pair_stats by {worst:.3e} relative")
        caps = [rung for key, (rung, _) in sharded._RING_LADDER.items()
                if key[0] == mesh.devices.shape]
        row = list(mesh.devices[0])

        def slots(k):
            return sharded._shard(packed[k][0], row)

        q_slots = slots("a_s")
        calls = []
        real = sharded._refine_local_pallas

        def spy(*args):
            out = real(*args)
            calls.append((args, out))
            return out

        sharded._refine_local_pallas = spy
        try:
            d, i, p, ovf = sharded.ring_nn_pruned(
                q_slots, slots("b_s"), slots("b_perm"), slots("b_lo"),
                slots("b_hi"), a.n, b.n,
                payload=sharded._shard(pay_b, row), cap=caps[0])
        finally:
            sharded._refine_local_pallas = real
        if any(bool(o) for o in ovf):
            raise AssertionError(f"the {label} a->b ring overflowed at the "
                                 "settled cap")
        d, i, p = torch.cat(d)[:a.n], torch.cat(i)[:a.n], torch.cat(p)[:a.n]
        if not (_bit_equal(d, want_d[:a.n]) and torch.equal(i,
                                                            want_i[:a.n])):
            raise AssertionError(f"the {label} a->b ring differs from "
                                 "nn_pruned_sorted")
        if not torch.equal(p, _payload_at(pay_b, packed["b_perm"][0], i)):
            raise AssertionError(f"the {label} a->b ring's payload rows are "
                                 "not b's at its ids")
        per_call = ring_k1_calls(f"the {label} a->b ring", calls, q_slots,
                                 a.n)
        del calls
        med = statistics.median(times)
        print(f"ring path 800k {label} " + json.dumps({
            "mesh": list(mesh.devices.shape), "pad": pad,
            "n_points": n_total, "settled_cap": caps[0],
            "k1_launches_a_call": (launches["refine_nn"] - warm) / RUNS,
            "first_call_s": first_s, "times_s": times, "median_s": med,
            "mpts_per_s": n_total / med / 1e6,
            "max_rel_vs_pair_stats": worst,
            "a->b_valid_rows_bit_identical": a.n,
            "a->b_k1_vs_plain": per_call,
            "launches": {k: v for k, v in launches.items() if v},
            "card": smi}), flush=True)
        out[f"ring path 800k {label}"] = launches["refine_nn"]
    return out


def ring_small_paths(s_origin, s_reconst, dev, smi):
    """The brute ring (``sharded_pair_stats``, plain torch: the JAX package
    runs XLA there) on the 60k pair with normals over RING_SLOTS slots of
    cuda:0 against the fused path's stats (K5) within RING_RTOL; then
    ``ring_normals_seed`` for the 60k origin and the 60k origins of the
    other NORMALS_SEEDS."""
    import torch

    import bench
    from open_pcc_metric_tpu_torch.ops.fused import pair_stats
    from open_pcc_metric_tpu_torch.parallel.sharded import (
        make_mesh, sharded_pair_stats)

    pad = _ring_pad(s_origin, s_reconst)
    a, b = _ring_cloud(s_origin, pad, dev), _ring_cloud(s_reconst, pad, dev)
    mesh = make_mesh(devices=[dev] * RING_SLOTS)

    def ring():
        st = sharded_pair_stats(
            mesh, a.points[None], b.points[None], [a.n], [b.n],
            a_col=a.colors[None], b_col=b.colors[None],
            a_nrm=a.normals[None], b_nrm=b.normals[None], **SWEEP_KW)
        torch.cuda.synchronize()
        return st

    stats = ring()
    times = []
    for _ in range(RING_RUNS):
        t0 = time.perf_counter()
        stats = ring()
        times.append(time.perf_counter() - t0)
    single = pair_stats(a.points, b.points, a.n, b.n, a.colors, b.colors,
                        a.normals, b.normals, backend="auto", **SWEEP_KW)
    worst = _max_rel(stats, single)
    if not worst <= RING_RTOL:
        raise AssertionError(f"the brute ring's stats are off the fused "
                             f"path's by {worst:.3e} relative")
    med = statistics.median(times)
    print("ring brute 60k " + json.dumps({
        "mesh": list(mesh.devices.shape), "pad": pad,
        "n_points": a.n + b.n, "times_s": times, "median_s": med,
        "mpts_per_s": (a.n + b.n) / med / 1e6,
        "max_rel_vs_fused": worst, "card": smi}), flush=True)

    seeds = []
    for seed in NORMALS_SEEDS:
        arrays = (s_origin if seed == 0
                  else bench.make_clouds(SMALL_POINTS, seed)[0])
        seeds.append(ring_normals_seed(
            arrays, _ring_pad(arrays), mesh, seed))
    print("ring normals 60k " + json.dumps({
        "slots": RING_SLOTS, "seeds": seeds, "dot_quantile": NORMALS_Q,
        "bar": NORMALS_DOT, "tie_free_bar": TIE_FREE_DOT, "card": smi}),
        flush=True)


def ring_normals_seed(arrays, pad, mesh, seed):
    """``ring_normals_pruned`` of one 60k origin without normals (its
    ladder from cap 16) against the single-device estimate: the
    NORMALS_Q-quantile of |dot| above NORMALS_DOT on every valid row. Then
    the 30-NN sets behind them, held without regard to tie order against a
    single-device 31-NN search (``ops.knn.knn``; every distance is exact on
    these integer points): the ring's 30 distances a row equal the
    search's, and on the rows whose 30th distance is below their 31st
    (one 30-NN set, whatever the tie order) the ring's neighbour
    coordinates are the search's as a set and its normal is the estimate's
    within TIE_FREE_DOT in |dot|. Rows with a tie at the 30th may hold
    different sets: the two searches break ties in different orders (the
    ring's merge keeps the earlier candidate). Returns the seed's record."""
    import torch

    from open_pcc_metric_tpu_torch.ops.grid import CHUNK
    from open_pcc_metric_tpu_torch.ops.knn import knn
    from open_pcc_metric_tpu_torch.parallel.sharded import (
        _shard, ring_knn_coords_pruned, ring_normals_pruned)

    c = _ring_cloud(arrays, pad, mesh.devices[0, 0], normals=False)
    g = c.get_grid()
    row = list(mesh.devices[0])
    ncl = pad // (len(row) * CHUNK)
    pts, lo, hi = (_shard(x, row) for x in (g.points, g.bbox_lo, g.bbox_hi))
    cap = 16
    t0 = time.perf_counter()
    while True:
        nrm, ovf = ring_normals_pruned(pts, lo, hi, c.n, k=K, cap=cap)
        if cap >= ncl or not any(bool(o) for o in ovf):
            break
        cap = min(cap * 4, ncl)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    n = c.n
    nrm = torch.cat(nrm)[:n]
    est = c.get_normals()[g.perm.long()][:n]
    dots = (nrm * est).sum(dim=1).abs().double()
    q = float(torch.quantile(dots.cpu(), NORMALS_Q))
    if not q > NORMALS_DOT:
        raise AssertionError(f"ring normals (seed {seed}) |dot| "
                             f"{NORMALS_Q}-quantile {q} <= {NORMALS_DOT}")
    dk, ck, _ = ring_knn_coords_pruned(pts, pts, lo, hi, n, k=K, cap=cap)
    dk, ck = torch.cat(dk)[:n], torch.cat(ck)[:n]
    p = g.points[:n]
    ref_i, ref_d = knn(p, p, k=K + 1)
    if not _bit_equal(dk, ref_d[:, :K].contiguous()):
        raise AssertionError(f"ring normals (seed {seed}): the ring's 30-NN "
                             "distances differ from the single-device ones")
    base = int(p.max()) + 1

    def keys(x):
        x = x.long()
        return ((x[..., 0] * base + x[..., 1]) * base
                + x[..., 2]).sort(dim=-1).values

    tie_free = ref_d[:, K - 1] < ref_d[:, K]
    same = (keys(ck) == keys(p[ref_i[:, :K].long()])).all(dim=1)
    if not bool(same[tie_free].all()):
        raise AssertionError(f"ring normals (seed {seed}): a tie-free row's "
                             "30-NN set differs from the single-device one")
    worst = float(dots[tie_free].min())
    if not worst > TIE_FREE_DOT:
        raise AssertionError(f"ring normals (seed {seed}): |dot| {worst} <= "
                             f"{TIE_FREE_DOT} on a tie-free row")
    return {"seed": seed, "n_points": n, "cap": cap, "ring_s": ring_s,
            "abs_dot": q, "tie_free_rows": int(tie_free.sum()),
            "tie_free_min_abs_dot": worst,
            "tied_rows_same_set": int(same[~tie_free].sum()),
            "tied_rows_abs_dot_min": (float(dots[~tie_free].min())
                                      if bool((~tie_free).any()) else None)}


def _table_rel(got, want):
    """The largest relative difference of table ``got`` from ``want``
    (equal entries, infinities included, count 0)."""
    worst = 0.0
    for key, w in want.items():
        g, w = np.asarray(got[key], np.float64), np.asarray(w, np.float64)
        rel = np.where(g == w, 0.0,
                       np.abs(g - w) / np.maximum(np.abs(w), 1e-30))
        worst = max(worst, float(np.max(rel)))
    return worst


@contextlib.contextmanager
def _sync_sites():
    """torch's synchronising-call warnings (``set_sync_debug_mode("warn")``)
    raised on this thread inside, as the list of their "file:line" sites
    (each a host readback or another wait on the device). Warnings of other
    threads (the OBB prefetch) are dropped."""
    import threading
    import traceback
    import warnings

    import torch

    me = threading.get_ident()
    root = os.getcwd()
    sites = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            if threading.get_ident() == me and "synchroniz" in str(message):
                site = f"{os.path.relpath(filename)}:{lineno}"
                if not os.path.abspath(filename).startswith(root):
                    # a library frame: name the repo's line that called it
                    ours = [f for f in traceback.extract_stack()[:-1]
                            if f.filename.startswith(root)]
                    if ours:
                        site += (f" from {os.path.relpath(ours[-1].filename)}"
                                 f":{ours[-1].lineno}")
                sites.append(site)

        # the mode first: switching it on may warn once itself
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = show
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def cold_fold_path(origin, reconst, dev, smi):
    """``fused_evaluate`` on fresh 800k clouds without normals through the
    cold-pair fold and stepwise (``_cold_fold_applicable`` forced off) in
    COLD_PAIRS alternating pairs of calls (fold first in even pairs,
    stepwise first in odd ones): wall seconds and where each call's wall
    went (``readback_s``: from the call's start to its last ``_to_host``,
    the device work; ``obb_done_s``: to the end of the OBB thread, which
    runs the hull beside it; ``after_readback_s``: from the last readback
    to the table, the wait for the OBB and the finalize), host waits a
    call (sync-debug warnings on the calling thread; the fold's is its one
    readback), the warnings inside ``cold_pair_program`` with their sites,
    and K1/K3/K4 launches a call.
    Checks: tables equal to rtol 1e-6, estimated normals within atol 2e-6,
    the 30-NN sets of both clouds bit-identical. Then the sweep's shape: the
    last fold turn's reference, fully cached, against fresh degraded clouds
    that estimate alone (est = (False, True)). Returns the launches of the
    fold calls, the path's counted run."""
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops import fused, knn_pruned, obb

    def make(data):
        c = Cloud.from_numpy(data[0], colors=data[1], device=dev)
        torch.cuda.synchronize()
        return c

    real_app, real_prog = fused._cold_fold_applicable, fused.cold_pair_program
    real_knn = knn_pruned.knn_pruned_sorted
    real_to_host, real_obb = fused._to_host, obb.minimal_obb_extent
    state = {"sites": None, "in_prog": [], "est": [], "knn": None,
             "readback": None, "obb_done": None}

    def to_host_spy(stats):
        # a readback of device values (finalize_stats passes host ones)
        out = real_to_host(stats)
        if any(isinstance(v, torch.Tensor) for v in stats.values()):
            state["readback"] = time.perf_counter()
        return out

    def obb_spy(*args, **kw):
        # on the OBB thread; timed before its future resolves
        out = real_obb(*args, **kw)
        state["obb_done"] = time.perf_counter()
        return out

    def prog_spy(*args, **kw):
        n0 = len(state["sites"])
        out = real_prog(*args, **kw)
        state["in_prog"].append(state["sites"][n0:])
        state["est"].append((kw["est_a"], kw["est_b"]))
        return out

    def knn_spy(*args, **kw):
        out = real_knn(*args, **kw)
        if state["knn"] is not None:
            state["knn"].append(out[:2])
        return out

    modes = {m: {"wall_s": [], "readback_s": [], "obb_done_s": [],
                 "after_readback_s": [], "waits": [], "sites": [],
                 "launches": [], "tables": [], "normals": None, "knn": None}
             for m in ("fold", "stepwise")}
    order = tuple(m for i in range(COLD_PAIRS) for m in (
        ("fold", "stepwise") if i % 2 == 0 else ("stepwise", "fold")))
    fused.cold_pair_program = prog_spy
    knn_pruned.knn_pruned_sorted = knn_spy
    fused._to_host, obb.minimal_obb_extent = to_host_spy, obb_spy
    restore = _guarded(_plain_names())
    try:
        for mode in order:
            rec = modes[mode]
            fused._cold_fold_applicable = (
                real_app if mode == "fold" else lambda *a_, **k_: False)
            a, b = make(origin), make(reconst)
            first = rec["normals"] is None
            state["knn"] = [] if first else None
            n_prog = len(state["in_prog"])
            state["readback"] = state["obb_done"] = None
            _reset_launches()
            with _sync_sites() as sites:
                state["sites"] = sites
                t0 = time.perf_counter()
                table = fused.fused_evaluate(a, b, **SWEEP_KW)
                t1 = time.perf_counter()
            rec["wall_s"].append(t1 - t0)
            rec["readback_s"].append(state["readback"] - t0)
            rec["after_readback_s"].append(t1 - state["readback"])
            rec["obb_done_s"].append(state["obb_done"] - t0)
            rec["launches"].append({k: v for k, v in _launches().items()
                                    if v})
            rec["waits"].append(len(sites))
            rec["sites"] += sites
            rec["tables"].append(table)
            took = len(state["in_prog"]) - n_prog
            if took != (mode == "fold"):
                raise AssertionError(f"a {mode} call ran the fold "
                                     f"{took} times")
            if first:
                rec["normals"] = (a._est_normals, b._est_normals)
                rec["knn"] = state["knn"]
                state["knn"] = None
        ref = (a, b)  # the last fold turn's clouds, every cache filled
        shape = {"wall_s": [], "waits": [], "launches": []}
        n_prog = len(state["in_prog"])
        for _ in range(EST_RUNS):
            b2 = make(reconst)
            _reset_launches()
            with _sync_sites() as sites:
                state["sites"] = sites
                t0 = time.perf_counter()
                table = fused.fused_evaluate(ref[0], b2, **SWEEP_KW)
                shape["wall_s"].append(time.perf_counter() - t0)
            shape["waits"].append(len(sites))
            shape["launches"].append({k: v for k, v in _launches().items()
                                      if v})
            worst = _table_rel(table, modes["stepwise"]["tables"][0])
            if not worst <= 1e-6:
                raise AssertionError(f"the sweep-shape fold's table is off "
                                     f"the stepwise one by {worst:.3e}")
        shape["est"] = state["est"][n_prog:]
        if shape["est"] != [(False, True)] * EST_RUNS:
            raise AssertionError(f"the sweep shape estimated {shape['est']}")
    finally:
        fused._cold_fold_applicable = real_app
        fused.cold_pair_program = real_prog
        knn_pruned.knn_pruned_sorted = real_knn
        fused._to_host, obb.minimal_obb_extent = real_to_host, real_obb
        restore()
    fold, step = modes["fold"], modes["stepwise"]
    worst = max(_table_rel(t, step["tables"][0])
                for t in fold["tables"] + step["tables"])
    if not worst <= 1e-6:
        raise AssertionError(f"fold and stepwise tables differ by {worst:.3e}")
    n_valid = (origin[0].shape[0], reconst[0].shape[0])
    nrm_err = max(float((x[:n] - y[:n]).abs().max()) for x, y, n in zip(
        fold["normals"], step["normals"], n_valid))
    if not nrm_err <= 2e-6:
        raise AssertionError(f"fold and stepwise normals differ by {nrm_err}")
    if len(fold["knn"]) != 2 or len(step["knn"]) != 2:
        raise AssertionError("one 30-NN a cloud was not captured")
    for (fd, fi), (sd, si), n in zip(fold["knn"], step["knn"], n_valid):
        if not (_bit_equal(fd[:n], sd[:n]) and _bit_equal(fi[:n], si[:n])):
            raise AssertionError("fold and stepwise 30-NN sets differ")
    in_prog = [s for sites in state["in_prog"] for s in sites]
    line = {"turns": order, "runs_a_turn": 1}
    for name, rec in modes.items():
        line[name] = {
            "wall_s": rec["wall_s"], "median_s": statistics.median(
                rec["wall_s"]),
            **{key: rec[key] for key in ("readback_s", "obb_done_s",
                                         "after_readback_s")},
            **{f"median_{key}": statistics.median(rec[key])
               for key in ("readback_s", "obb_done_s", "after_readback_s")},
            "host_waits_a_call": rec["waits"],
            "wait_sites": sorted(set(rec["sites"])),
            "launches_a_call": rec["launches"][0],
        }
    line["fold"]["sync_warnings_in_cold_pair_program"] = len(in_prog)
    line["fold"]["sync_sites_in_cold_pair_program"] = sorted(set(in_prog))
    line["sweep_shape"] = {
        "est": shape["est"][0], "wall_s": shape["wall_s"],
        "median_s": statistics.median(shape["wall_s"]),
        "host_waits_a_call": shape["waits"],
        "launches_a_call": shape["launches"][0]}
    line["checks"] = {"table_max_rel": worst, "normals_max_abs": nrm_err,
                      "knn_sets_bit_identical": True}
    line["card"] = smi
    print("cold fold 800k " + json.dumps(line), flush=True)
    totals = {}
    for launches in fold["launches"]:
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def bucketed_path(origin, reconst, dev, smi):
    """``nn_pruned_bucketed_sorted`` a->b and b->a on the 800k pair at its
    defaults (p1 8, b1_extra 40) and at p1 24, against ``nn_pruned_sorted``
    at the main path's base rung: bit-identical on valid rows whenever the
    overflow flag is clear, and certified at one of the two settings in
    each direction. Prints the flag, K1 launches and ms (CUDA events, mean
    of 5) of each. Returns the K1 launches of the checked calls."""
    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops.nn_pruned import (
        nn_pruned_bucketed_sorted, nn_pruned_sorted)

    a = Cloud.from_numpy(origin[0], device=dev)
    b = Cloud.from_numpy(reconst[0], device=dev)
    ga, gb = a.get_grid(), b.get_grid()
    recs, total = {}, 0
    for label, gq, gs, nq in (("a->b", ga, gb, a.n), ("b->a", gb, ga, b.n)):
        want = nn_pruned_sorted(gq, gs, nq, cap=CAP, fallback_tiles=FALLBACK)
        if bool(want[2]):
            raise AssertionError(f"the {label} default sweep overflowed")
        default_ms = _time_ms(lambda: nn_pruned_sorted(
            gq, gs, nq, cap=CAP, fallback_tiles=FALLBACK), 5)
        certified = False
        for p1 in (8, 24):
            _reset_launches()
            got = nn_pruned_bucketed_sorted(gq, gs, nq, p1=p1)
            launches = _launches()["refine_nn"]
            total += launches
            overflow = bool(got[2])
            if not overflow:
                if not (_bit_equal(got[0][:nq], want[0][:nq])
                        and _bit_equal(got[1][:nq], want[1][:nq])):
                    raise AssertionError(f"the bucketed {label} sweep "
                                         "differs from the default")
                certified = True
            recs[f"{label} p1 {p1}"] = {
                "overflow": overflow, "k1_launches": launches,
                "ms": _time_ms(lambda: nn_pruned_bucketed_sorted(
                    gq, gs, nq, p1=p1), 5),
                "default_ms": default_ms,
                "bit_identical": None if overflow else True}
        if not certified:
            raise AssertionError(f"the bucketed {label} sweep certified at "
                                 "neither setting")
    print("bucketed 800k " + json.dumps({"sweeps": recs, "card": smi}),
          flush=True)
    return total


def api_parity_path(origin, reconst, dev, smi):
    """Calls made the JAX package's way on the card: ``nn_pruned_sorted``
    on the 800k a->b sweep (an mxu_exact pair) under the JAX package's
    ``refine_impl`` names, with the refine knobs unset and the plain
    versions guarded, each with K1's launches and every other kernel's
    equal to "default"'s and its rows bit-identical; the JAX-style
    positional ``nn_chunked(q, q, True, 256, 1024)`` on a 4000-point CUDA
    cloud equal to the keyword call; and ``synthetic_voxel_pair(...,
    torch.float32, device=dev)`` drawing the CPU's points and colours.
    Prints the ``api parity`` line with the phase's wall time."""
    import torch

    from open_pcc_metric_tpu_torch.cloud import Cloud, synthetic_voxel_pair
    from open_pcc_metric_tpu_torch.ops.nn import nn_chunked
    from open_pcc_metric_tpu_torch.ops.nn_pruned import nn_pruned_sorted

    t0 = time.perf_counter()
    a = Cloud.from_numpy(origin[0], device=dev)
    b = Cloud.from_numpy(reconst[0], device=dev)
    ga, gb = a.get_grid(), b.get_grid()
    mxu_ok = a.mxu_exact() and b.mxu_exact()
    names = {}
    restore = _guarded(_plain_names())
    try:
        with _env({"PCC_REFINE_IMPL": None, "PCC_NN_EXPANDED": None}):
            want, want_launches = None, None
            for name in ("default", "auto", "pallas", "pallas_interpret",
                         "xla"):
                _reset_launches()
                got = nn_pruned_sorted(ga, gb, a.n, cap=CAP,
                                       fallback_tiles=FALLBACK,
                                       refine_impl=name, mxu_ok=mxu_ok)
                torch.cuda.synchronize()
                launches = _launches()
                if launches["refine_nn"] <= 0:
                    raise AssertionError(f"refine_impl={name!r} launched "
                                         "no K1")
                if want is None:
                    want, want_launches = got, launches
                elif launches != want_launches or not all(
                        _bit_equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"refine_impl={name!r} differs from "
                                         "'default'")
                names[name] = {"k1_launches": launches["refine_nn"],
                               "bit_identical": True}
    finally:
        restore()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(0, 64, (4000, 3)).astype(
        np.float32)).to(dev)
    pos = nn_chunked(q, q, True, 256, 1024)
    kw = nn_chunked(q, q, exclude_self=True)
    if not all(_bit_equal(x, y) for x, y in zip(pos, kw)):
        raise AssertionError("the JAX-style nn_chunked call differs from the "
                             "keyword call")
    on_card = synthetic_voxel_pair(4000, 512, 0, True, torch.float32,
                                   device=dev)
    on_cpu = synthetic_voxel_pair(4000, 512, 0, True, torch.float32,
                                  device="cpu")
    for c, h in zip(on_card, on_cpu):
        if c.n != h.n or not (torch.equal(c.points.cpu(), h.points)
                              and torch.equal(c.colors.cpu(), h.colors)):
            raise AssertionError("synthetic_voxel_pair on the card differs "
                                 "from the CPU's")
    wall = time.perf_counter() - t0
    print("api parity " + json.dumps({
        "nn_pruned_sorted 800k a->b": names, "mxu_ok": mxu_ok,
        "nn_chunked 4000 positional equals keyword": True,
        "synthetic_voxel_pair card equals cpu": True,
        "seconds": wall, "card": smi}), flush=True)


def main() -> int:
    import torch

    import bench
    from open_pcc_metric_tpu_torch.cloud import Cloud
    from open_pcc_metric_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # No TF32: every float32 product stays full float32 (stated and set).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    built = _build.load_many(list(KERNELS))
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, in parallel)", flush=True)
    for name, lib in built.items():
        print(f"build: csrc/{name}.cu -> {lib.path}", flush=True)
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas {name}: " + line.strip())

    t0 = time.perf_counter()
    origin, reconst = bench.make_clouds(N_POINTS)
    rng = np.random.default_rng(1)
    float_pts = origin[0] + rng.uniform(-0.5, 0.5, origin[0].shape)
    print(f"clouds: {origin[0].shape[0]} + {reconst[0].shape[0]} points "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    a = Cloud.from_numpy(origin[0], device=dev)
    b = Cloud.from_numpy(reconst[0], device=dev)
    fcloud = Cloud.from_numpy(float_pts, device=dev)
    records = kernel_phases(a, b, fcloud)
    k7_recs, _ = adaptive_phases(a, b)
    k6_recs = payload_phases(origin, reconst, dev)
    k3_recs, k4_recs = knn_phases(a, fcloud)
    tail_k1, tail_k3, tail_k4 = tail_phases(a, b)
    records += tail_k1
    k3_recs += tail_k3
    k4_recs += tail_k4
    ga, gb, gf = a.get_grid(), b.get_grid(), fcloud.get_grid()
    k2a_recs, k2b_recs = select_phases([
        ("800k a->b", ga, gb, a.n, CAP, False),
        ("800k b->a", gb, ga, b.n, CAP, False),
        ("800k self a->a", ga, ga, a.n, CAP, True),
        ("800k a->b escalated cap", ga, gb, a.n, 512, False),
        ("800k float a->b", gf, gb, fcloud.n, CAP, False),
    ])
    k2a_recs += k2a_wide_phases(dev)
    prologue_ab("800k", [("a->b", ga, gb, a.n, False),
                         ("b->a", gb, ga, b.n, False),
                         ("self a->a", ga, ga, a.n, True)], smi)
    # The fixed schedule's kernels at its stage-1 shapes: K2c, then K1b and
    # K1c beside K1 ungated, then K3b beside K3 ungated.
    k2c_recs = k2c_phases([
        ("800k a->b", ga, gb, a.n, CAP), ("800k b->a", gb, ga, b.n, CAP),
        ("800k self a->a", ga, ga, a.n, CAP),
        ("800k self a->a k-NN cap", ga, ga, a.n, KCAP),
        ("800k a->b escalated cap", ga, gb, a.n, 512),
    ])
    k1b_recs, k1c_recs = straight_phases([
        ("800k a->b", ga, gb, a.n, False), ("800k b->a", gb, ga, b.n, False),
        ("800k self a->a", ga, ga, a.n, True),
        ("800k float a->b", gf, gb, fcloud.n, False),
    ])
    k3b_recs = knn_straight_phases([("800k a->a", ga, a.n),
                                    ("800k float a->a", gf, fcloud.n),
                                    ("800k reconst b->b", gb, b.n)])
    del a, b, fcloud, ga, gb, gf
    torch.cuda.empty_cache()

    a, b, result, first_s, times, launches = main_path(origin, reconst, dev)
    n_total = a.n + b.n
    med = statistics.median(times)
    print("main path " + json.dumps({
        "n_points": n_total, "first_call_s": first_s,
        "times_s": times, "median_s": med,
        "mpts_per_s": n_total / med / 1e6, "k1_launches": launches["refine_nn"],
        "card": smi,
    }), flush=True)
    sweeps, _ = oracle_checks(a, b, origin, reconst, result,
                              pruned_search, "")
    del a, b
    torch.cuda.empty_cache()

    kwargs = dict(color_scheme="ycc", point_to_plane=True, d2_mode="pc_error")
    from open_pcc_metric_tpu_torch.ops.fused import fused_evaluate

    def evaluate(a, b):
        return fused_evaluate(a, b, **kwargs)

    def same_table(table, label):
        if any(not np.array_equal(np.asarray(result[k]), np.asarray(table[k]))
               for k in result):
            raise AssertionError(f"the {label} table differs from the main "
                                 "path's")

    def k1_never(launches):
        if launches["refine_nn"]:
            raise AssertionError("an adaptive turn launched K1")

    # The adaptive schedule (K7) and the payload schedule (K6) on the 800k
    # pair with normals, each in turns with the default; the ladder memo's
    # key names the schedule, so no turn starts from another's rung. K7's
    # launches by pass are those of the first adaptive turn, the path's
    # counted run.
    k7_passes = {"P1": 0, "P2": 0, "P3": 0}
    k7_first_turn = {}

    def k1_never_and_k7_passes(launches):
        k1_never(launches)
        if not k7_first_turn:
            k7_first_turn.update(k7_passes)
            if sum(k7_first_turn.values()) != launches["adaptive_refine"]:
                raise AssertionError("K7's passes do not add up to its "
                                     "launches")

    want = _want_psnrs(origin, reconst, sweeps, origin[2], reconst[2])
    with _k7_passes(k7_passes):
        (a, b), ad_launches, rec, table = schedule_path(
            "the 800k adaptive path", ADAPTIVE_ENV, "adaptive_refine",
            lambda: _pair_clouds(origin, reconst, dev), evaluate, RUNS, smi,
            check_on=k1_never_and_k7_passes)
    rec["k7_launches_by_pass"] = k7_first_turn
    same_table(table, "adaptive")
    rec["sweeps"] = schedule_sweeps(a, b, "800k", "adaptive", sweeps)
    rec["max_dpsnr_vs_oracle"] = max(_psnr_deltas(table, want).values())
    if not rec["max_dpsnr_vs_oracle"] <= PSNR_TOL:
        raise AssertionError("the adaptive path's PSNRs are off the oracle")
    print("adaptive path 800k " + json.dumps(rec), flush=True)
    del a, b
    torch.cuda.empty_cache()

    def two_k6_a_call(launches):
        if launches["refine_nn_payload"] != 2 * (RUNS + 1):
            raise AssertionError("the payload path did not launch K6 twice "
                                 "a call")

    (a, b), pay_launches, rec, table = schedule_path(
        "the 800k payload path", PAYLOAD_ENV, "refine_nn_payload",
        lambda: _pair_clouds(origin, reconst, dev), evaluate, RUNS, smi,
        check_on=two_k6_a_call)
    same_table(table, "payload")
    rec["sweep_rows_off_oracle"] = payload_sweeps(a, b, "800k", sweeps)
    rec["max_dpsnr_vs_oracle"] = max(_psnr_deltas(table, want).values())
    if not rec["max_dpsnr_vs_oracle"] <= PSNR_TOL:
        raise AssertionError("the payload path's PSNRs are off the oracle")
    print("payload path 800k " + json.dumps(rec), flush=True)
    schedule_split(a, b, "800k", smi)
    del a, b
    torch.cuda.empty_cache()
    float_adaptive_line((float_pts, origin[1], origin[2]), reconst, dev,
                        evaluate, smi)

    # The select prologue on the 800k pair with normals, in turns.
    (a, b), sel_launches, rec, table = prologue_path(
        "the 800k select path", lambda: _pair_clouds(origin, reconst, dev),
        evaluate, RUNS, smi)
    same_table(table, "select")
    rec["sweep_rows_off_oracle"] = sweeps_identical(a, b, "800k", sweeps)
    rec["sweeps_bit_identical_to_default"] = True
    print("select path 800k " + json.dumps(rec), flush=True)
    del a, b
    torch.cuda.empty_cache()

    # The fixed-cap schedule (K2c + K1b stage 1) on the 800k pair with
    # normals, in turns with the counted default: once a sweep, so both
    # cross sweeps every call and the self sweep in the first call only
    # (its boundary stats are cached on the cloud).
    def once_a_sweep(launches):
        want_n = 2 * (RUNS + 1) + 1
        got_n = (launches["select_candidates"], launches["refine_nn_straight"])
        if got_n != (want_n, want_n):
            raise AssertionError(f"the fixed path launched K2c and K1b "
                                 f"{got_n} times, not {want_n}")

    (a, b), fixed_launches, rec, table = schedule_path(
        "the 800k fixed path", FIXED_ENV, "refine_nn_straight",
        lambda: _pair_clouds(origin, reconst, dev), evaluate, RUNS, smi,
        order=("on", "off", "off", "on"), check_on=once_a_sweep)
    if "select_candidates" in rec["launches_off"]:
        raise AssertionError("the counted schedule launched K2c")
    same_table(table, "fixed")
    rec["sweep_rows_off_oracle"] = fixed_sweeps(a, b, sweeps)
    rec["sweeps_bit_identical_to_default"] = True
    rec["max_dpsnr_vs_oracle"] = max(_psnr_deltas(table, want).values())
    print("fixed path 800k " + json.dumps(rec), flush=True)
    fixed_split(a, b, smi)
    del a, b
    torch.cuda.empty_cache()

    ea, eb, est_result, est_first, est_times, est_launches = estimation_path(
        origin, reconst, dev)
    est_med = statistics.median(est_times)
    print("estimation path " + json.dumps({
        "n_points": n_total, "first_call_s": est_first,
        "times_s": est_times, "median_s": est_med,
        "mpts_per_s": n_total / est_med / 1e6,
        "k1_launches": est_launches["refine_nn"],
        "k3_launches": est_launches["refine_knn"],
        "k4_launches": est_launches["knn_moments"],
        "knn_split": estimation_split([("origin", ea), ("reconst", eb)], smi),
        "cold_profile": cold_profile(origin, reconst, dev),
        "card": smi,
    }), flush=True)
    knn_oracle = {}
    estimation_checks(ea, eb, origin, reconst, est_result, sweeps, knn_oracle)
    del ea, eb
    torch.cuda.empty_cache()
    ea, eb, sel_est_result, sel_first, sel_times, sel_est_launches = (
        estimation_path(origin, reconst, dev, prologue="select"))
    sel_med = statistics.median(sel_times)
    sel_checks = estimation_checks(ea, eb, origin, reconst, sel_est_result,
                                   sweeps, knn_oracle, prologue="select")
    print("select estimation path " + json.dumps({
        "n_points": n_total, "first_call_s": sel_first,
        "times_s": sel_times, "median_s": sel_med,
        "mpts_per_s": n_total / sel_med / 1e6,
        "default_median_s": est_med,
        "launches": {k: v for k, v in sel_est_launches.items() if v},
        "checks": sel_checks, "card": smi,
    }), flush=True)
    del ea, eb
    torch.cuda.empty_cache()
    ea, eb, fx_result, fx_first, fx_times, fx_launches = estimation_path(
        origin, reconst, dev, env=FIXED_KNN_ENV)
    for name in ("select_candidates", "refine_nn_straight",
                 "refine_knn_straight"):
        if fx_launches[name] <= 0:
            raise AssertionError(f"the fixed estimation path launched {name} "
                                 "no time")
    fx_checks = estimation_checks(ea, eb, origin, reconst, fx_result, sweeps,
                                  knn_oracle, sched="fixed")
    with _env(FIXED_KNN_ENV):
        fx_profile = cold_profile(origin, reconst, dev)
    print("fixed estimation path 800k " + json.dumps({
        "n_points": n_total, "env": FIXED_KNN_ENV, "first_call_s": fx_first,
        "times_s": fx_times, "median_s": statistics.median(fx_times),
        "mpts_per_s": n_total / statistics.median(fx_times) / 1e6,
        "default_median_s": est_med,
        "k3b_launches": fx_launches["refine_knn_straight"],
        "launches": {k: v for k, v in fx_launches.items() if v},
        "checks": fx_checks, "cold_profile": fx_profile, "card": smi,
    }), flush=True)
    del ea, eb
    torch.cuda.empty_cache()
    # The cold-pair fold against stepwise and the bucketed 1-NN, each on
    # the 800k pair.
    fold_launches = cold_fold_path(origin, reconst, dev, smi)
    torch.cuda.empty_cache()
    bucketed_k1 = bucketed_path(origin, reconst, dev, smi)
    torch.cuda.empty_cache()
    api_parity_path(origin, reconst, dev, smi)
    torch.cuda.empty_cache()
    dag_big = dag_path(origin, reconst, dev, "refine_nn")
    torch.cuda.empty_cache()

    # The small-cloud path: the largest pair the brute force serves.
    t0 = time.perf_counter()
    s_origin, s_reconst = bench.make_clouds(SMALL_POINTS)
    s_float = s_origin[0] + rng.uniform(-0.5, 0.5, s_origin[0].shape)
    sa = Cloud.from_numpy(s_origin[0], device=dev)
    sb = Cloud.from_numpy(s_reconst[0], device=dev)
    print(f"small clouds: {sa.n} + {sb.n} points, padded {sa.padded_size} "
          f"and {sb.padded_size} rows ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    k5_recs = brute_phases(sa, sb, Cloud.from_numpy(s_float, device=dev))
    del sa, sb
    torch.cuda.empty_cache()
    sa, sb, s_result, s_first, s_times, s_launches = small_path(
        s_origin, s_reconst, dev)
    s_total = sa.n + sb.n
    s_med = statistics.median(s_times)
    _, s_delta = oracle_checks(sa, sb, s_origin, s_reconst, s_result,
                               brute_search, "small path ")
    print("small-cloud path " + json.dumps({
        "n_points": s_total, "padded_rows": [sa.padded_size, sb.padded_size],
        "first_call_s": s_first, "times_s": s_times, "median_s": s_med,
        "mpts_per_s": s_total / s_med / 1e6,
        "k5_launches": s_launches["nn_brute"],
        "max_dpsnr_vs_oracle": s_delta, "sweep_rows_off_oracle": 0,
        "card": smi,
    }), flush=True)
    del sa, sb
    dag_small = dag_path(s_origin, s_reconst, dev, "nn_brute")
    print("dag path " + json.dumps({"small pair (K5)": dag_small,
                                    "800k pair (K1)": dag_big,
                                    "card": smi}), flush=True)
    torch.cuda.empty_cache()
    k8_recs, k8_launches = knn_brute_phases(dev)
    torch.cuda.empty_cache()
    k9_recs, k9_launches = ply_decode_phases(dev, smi)

    # The 2M pair: K2a/K2b phases, the prologue A/B, the pair in turns and
    # a stage split per sweep.
    t0 = time.perf_counter()
    b_origin, b_reconst = bench.make_clouds(N_BIG)
    a = Cloud.from_numpy(b_origin[0], device=dev)
    b = Cloud.from_numpy(b_reconst[0], device=dev)
    ga, gb = a.get_grid(), b.get_grid()
    print(f"2M clouds: {a.n} + {b.n} points, padded {a.padded_size} and "
          f"{b.padded_size} rows ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    more_a, more_b = select_phases([
        ("2M a->b", ga, gb, a.n, CAP, False),
        ("2M self a->a", ga, ga, a.n, CAP, True),
    ])
    k2a_recs += more_a
    k2b_recs += more_b
    k2c_recs += k2c_phases([("2M a->b", ga, gb, a.n, CAP),
                            ("2M self a->a", ga, ga, a.n, CAP)])
    ab_2m = prologue_ab("2M", [("a->b", ga, gb, a.n, False),
                               ("b->a", gb, ga, b.n, False),
                               ("self a->a", ga, ga, a.n, True)], smi)
    del a, b, ga, gb
    torch.cuda.empty_cache()
    (a, b), _, rec, table_2m = prologue_path(
        "the 2M pair", lambda: _pair_clouds(b_origin, b_reconst, dev),
        evaluate, RUNS, smi)
    sweeps_identical(a, b, "2M")
    rec["sweeps_bit_identical_to_default"] = True
    print("select path 2M " + json.dumps(rec), flush=True)
    stage_split(a, b, smi, ab_2m)
    del a, b
    torch.cuda.empty_cache()
    # The adaptive schedule at 2M: one pair of turns, and each sweep's P3.
    (a, b), _, rec, table = schedule_path(
        "the 2M adaptive path", ADAPTIVE_ENV, "adaptive_refine",
        lambda: _pair_clouds(b_origin, b_reconst, dev), evaluate, RUNS, smi,
        order=("on", "off"), check_on=k1_never)
    if any(not np.array_equal(np.asarray(table_2m[k]), np.asarray(table[k]))
           for k in table):
        raise AssertionError("the 2M adaptive table differs from the "
                             "default's")
    rec["sweeps"] = schedule_sweeps(a, b, "2M", "adaptive")
    print("adaptive path 2M " + json.dumps(rec), flush=True)
    schedule_split(a, b, "2M", smi, payload=False)
    del a, b
    torch.cuda.empty_cache()

    # The QP sweep: run_sweep over six degraded frames of one reference,
    # then run_sweep_sharded over the same files.
    _, _, _, sharded_rec = sweep_path(dev, smi)
    torch.cuda.empty_cache()

    # The ring: the pruned ring on the 800k pair, then the brute ring and
    # the ring normals on the 60k pair.
    ring_launches = ring_path(origin, reconst, dev, smi)
    ring_launches["sharded sweep 800k"] = sharded_rec["launches"]["refine_nn"]
    torch.cuda.empty_cache()
    ring_small_paths(s_origin, s_reconst, dev, smi)
    torch.cuda.empty_cache()

    for name in ("jax", "open_pcc_metric_tpu"):
        if name in sys.modules:
            raise AssertionError(f"{name} was imported")
    # (path, launches on its counted run) of each kernel
    path_launches = {
        "refine_nn": ("main path", launches["refine_nn"]),
        "refine_knn": ("estimation path", est_launches["refine_knn"]),
        "knn_moments": ("estimation path", est_launches["knn_moments"]),
        "nn_brute": ("small-cloud path", s_launches["nn_brute"]),
        "select_bbox": ("select path 800k", sel_launches["select_bbox"]),
        "count_bbox": ("select path 800k", sel_launches["count_bbox"]),
        "adaptive_refine": ("adaptive path 800k",
                            ad_launches["adaptive_refine"]),
        "refine_nn_payload": ("payload path 800k",
                              pay_launches["refine_nn_payload"]),
        "select_candidates": ("fixed path 800k",
                              fixed_launches["select_candidates"]),
        "refine_nn_straight": ("fixed path 800k",
                               fixed_launches["refine_nn_straight"]),
        "refine_knn_straight": ("fixed estimation path 800k",
                                fx_launches["refine_knn_straight"]),
        "refine_nn_fused": (None, 0),
        "knn_brute": ("small-cloud estimation path", k8_launches),
        "ply_decode": ("ply decode", k9_launches),
    }
    phase_recs = {"refine_nn": records, "refine_knn": k3_recs,
                  "knn_moments": k4_recs, "nn_brute": k5_recs,
                  "select_bbox": k2a_recs, "count_bbox": k2b_recs,
                  "adaptive_refine": k7_recs, "refine_nn_payload": k6_recs,
                  "select_candidates": k2c_recs,
                  "refine_nn_straight": k1b_recs,
                  "refine_knn_straight": k3b_recs,
                  "refine_nn_fused": k1c_recs, "knn_brute": k8_recs,
                  "ply_decode": k9_recs}
    kernels = []
    for name in KERNELS:
        full = _full_phase(phase_recs[name])
        path, n_launches = path_launches[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"open_pcc_metric_tpu_torch/csrc/{name}.cu",
            "replaces": KERNELS[name],
            "path": path,
            "launches": n_launches,
            "max_abs_err": max(r["max_abs_err"] for r in phase_recs[name]),
            "ms": full["ms"],
            "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"],
            "bound_by": full["bound_by"],
            "library_ms": full.get("library_ms"),
            "phase": full["phase"],
        })
        if name == "refine_nn":
            kernels[-1]["ring_launches"] = ring_launches
        if name in ("refine_nn", "refine_knn", "knn_moments"):
            more = {"cold fold 800k": fold_launches.get(name, 0)}
            if name == "refine_nn":
                more["bucketed 800k"] = bucketed_k1
            if min(more.values()) <= 0:
                raise AssertionError(f"{name} was launched on no run of "
                                     f"{more}")
            kernels[-1]["more_launches"] = more
        if kernels[-1]["launches"] <= 0 and name not in NO_PATH:
            raise AssertionError(f"{name} was launched on no path")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
