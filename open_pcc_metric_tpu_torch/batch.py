"""Batch / sequence-sweep evaluation with a resumable JSONL journal.

The counterpart of the JAX package's ``batch.py``: a codec lab scores
every decoded frame of every rate point against one reference, and the
reference tool has no batch mode.

  * a manifest of (original, processed) pairs — explicit CSV or two
    directories paired by filename;
  * per-frame results appended to a JSONL journal as they complete, so an
    interrupted sweep resumes by skipping finished frames;
  * per-file failures are logged into the journal and skipped (fail-fast per
    frame, not per sweep);
  * reference clouds are cached across items, so a QP sweep (one reference
    x N degraded clouds) loads, uploads, Morton-sorts and hulls the
    reference once;
  * a 3-deep prefetch parses and uploads the next pairs' files on side
    threads (each with its own CUDA stream) while the device evaluates the
    current pair;
  * ``run_sweep_sharded``: frame groups on a ("frames", "points") mesh of
    devices through the ring (``parallel/sharded.py``), the JAX package's
    multi-device sweep.

The sweep runs on the CUDA device unless ``device`` names another.

CLI: ``python -m open_pcc_metric_tpu_torch.batch --help``.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures as _cf
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
import typing

import numpy as np
import torch

from .cloud import pad_bucket, resolve_device
from .evaluate import Device, load_cloud
from .io import point_count
from .ops.fused import fused_evaluate
from .ops.nn import BACKENDS
from .utils import get_logger
from .utils.profiling import bind, mpoints_per_sec, new_pair, span, spanned

logger = get_logger(__name__)

PREFETCH_DEPTH = 3


@dataclasses.dataclass
class SweepItem:
    ocloud: str
    pcloud: str
    tag: str


def pairs_from_dirs(odir: str, pdir: str) -> typing.List[SweepItem]:
    """Pair files from two directories by (sorted) filename."""
    ofiles = sorted(
        f for f in os.listdir(odir)
        if f.lower().endswith((".ply", ".pcd", ".xyz"))
    )
    items = []
    for f in ofiles:
        p = os.path.join(pdir, f)
        if os.path.exists(p):
            items.append(SweepItem(os.path.join(odir, f), p, tag=f))
        else:
            logger.warning("no processed counterpart for %s", f)
    return items


def pairs_from_manifest(path: str) -> typing.List[SweepItem]:
    """CSV manifest: ocloud,pcloud[,tag] per line (header optional)."""
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if parts[0].lower() in ("ocloud", "original"):
                continue
            tag = parts[2] if len(parts) > 2 else os.path.basename(parts[1])
            items.append(SweepItem(parts[0], parts[1], tag))
    return items


def _read_journal(path: str) -> typing.Dict[str, dict]:
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "tag" in rec and "error" not in rec:
                    done[rec["tag"]] = rec
    return done


class _CloudCache:
    """Small LRU of loaded clouds keyed by (path, dtype, pad_to, device).

    Thread-safe with single-flight loading: when two prefetch workers ask
    for the same cloud (e.g. the shared reference of a QP sweep while the
    pipeline is still filling), the second blocks on the first's future
    instead of parsing and uploading the file twice. A CUDA cloud carries
    ``_upload_event``, recorded on the loading thread's stream after its
    uploads and widen steps, so any thread can wait for them.
    """

    def __init__(self, capacity: int = 6):
        self._cap = capacity
        self._lock = threading.Lock()
        self._store: "typing.OrderedDict" = collections.OrderedDict()

    def get(self, path: str, dtype: str, pad_to=None, device: Device = None):
        device = resolve_device(device)
        key = (path, dtype, pad_to, str(device))
        with self._lock:
            fut = self._store.get(key)
            if fut is not None:
                self._store.move_to_end(key)
                mine = None
            else:
                mine = _cf.Future()
                self._store[key] = mine
                if len(self._store) > self._cap:
                    self._store.popitem(last=False)
        if mine is None:
            return fut.result()
        try:
            cloud = load_cloud(path, dtype=dtype, pad_to=pad_to, device=device)
            if device.type == "cuda":
                cloud._upload_event = torch.cuda.Event()
                cloud._upload_event.record(torch.cuda.current_stream(device))
        except BaseException as e:
            mine.set_exception(e)
            with self._lock:
                if self._store.get(key) is mine:
                    del self._store[key]  # allow a retry next time
            raise
        mine.set_result(cloud)
        return cloud


def _finish_upload(cloud, stream) -> None:
    """Wait out a cloud's uploads, once: the host waits on its upload
    event, and each tensor is marked in use on ``stream`` (the evaluating
    thread's), so the caching allocator does not hand its block to the
    loading stream while work queued on ``stream`` may still read it after
    the cache evicts the cloud."""
    if getattr(cloud, "_upload_synced", False):
        return
    event = getattr(cloud, "_upload_event", None)
    if event is not None:
        with span("pcc.upload"):
            event.synchronize()
        for t in (cloud.points, cloud.colors, cloud.normals):
            if t is not None:
                t.record_stream(stream)
    cloud._upload_synced = True


@spanned("pcc.run_sweep")
def run_sweep(
    items: typing.Sequence[SweepItem],
    journal_path: str,
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    d2_mode: str = "reference",
    dtype: str = "float32",
    backend: str = "auto",
    resume: bool = True,
    pad: str = "common",
    peak: typing.Optional[float] = None,
    *,
    device: Device = None,
) -> typing.List[dict]:
    """Evaluate every pair on ``device`` (the CUDA device when None; raises
    when there is none), appending one JSONL record per frame.

    ``pad="common"`` (default) sizes every cloud to ONE shared pad bucket
    (headers are scanned up-front via io.point_count), so every pair of a
    QP/rate sweep has the same shapes and shares the ladder memo's rung.
    ``pad="per-pair"`` restores individual buckets (smaller arrays).
    """
    device = resolve_device(device)
    done = _read_journal(journal_path) if resume else {}
    cache = _CloudCache()
    pad_to = None
    if pad == "common" and items:
        biggest = 0
        for it in items:
            for path in (it.ocloud, it.pcloud):
                try:
                    biggest = max(biggest, point_count(path))
                except (OSError, ValueError):
                    pass  # unreadable now -> per-pair error later
        if biggest:
            pad_to = pad_bucket(biggest)
    # Prefetch pipeline: while the device evaluates pair i, side threads
    # parse pairs i+1..i+3's files and upload them, each thread on its own
    # CUDA stream so the uploads and widen steps overlap the evaluation on
    # this thread's stream instead of queueing behind it.
    todo = [it for it in items if it.tag not in done]
    todo_index = {it.tag: i for i, it in enumerate(todo)}
    cuda = device.type == "cuda"
    main_stream = torch.cuda.current_stream(device) if cuda else None
    local = threading.local()

    def _stream():
        if not cuda:
            return contextlib.nullcontext()
        if getattr(local, "stream", None) is None:
            local.stream = torch.cuda.Stream(device)
        return torch.cuda.stream(local.stream)

    def _fetch(item):
        t0 = time.perf_counter()
        with _stream():
            a = cache.get(item.ocloud, dtype, pad_to, device)
            b = cache.get(item.pcloud, dtype, pad_to, device)
        t1 = time.perf_counter()
        with span("pcc.load"):
            for c in (a, b):
                _finish_upload(c, main_stream)
        t2 = time.perf_counter()
        # Stage split: parse = file IO, padding and the upload calls on the
        # prefetch thread; upload = waiting out the transfers and widen
        # steps. Both overlap the previous pair's device work; load_wait_s
        # is what actually extended the sweep's critical path.
        return a, b, {"parse_s": round(t1 - t0, 4),
                      "upload_s": round(t2 - t1, 4)}

    # Each pair's spans, its prefetch's included, carry its own pair id.
    pair_ids = {it.tag: new_pair() for it in todo}
    fetch = {it.tag: bind(_fetch, pair=pair_ids[it.tag]) for it in todo}
    prefetcher = _cf.ThreadPoolExecutor(PREFETCH_DEPTH)
    futures = {}
    if todo:
        futures[todo[0].tag] = prefetcher.submit(fetch[todo[0].tag], todo[0])

    def _prefetched(item):
        """``item``'s prefetch, after the next PREFETCH_DEPTH are submitted
        (before resolving this one, so a failed load still keeps the
        pipeline running)."""
        fut = futures.pop(item.tag, None)
        if fut is None:  # self-heal a severed prefetch chain
            fut = prefetcher.submit(fetch[item.tag], item)
        pos = todo_index[item.tag]
        for nxt in todo[pos + 1:pos + 1 + PREFETCH_DEPTH]:
            if nxt.tag not in futures:
                futures[nxt.tag] = prefetcher.submit(fetch[nxt.tag], nxt)
        return fut

    def _evaluate(item) -> dict:
        rec: dict = {"tag": item.tag, "ocloud": item.ocloud,
                     "pcloud": item.pcloud, "ts": time.time()}
        try:
            with span("pcc.load_wait"):
                t0 = time.perf_counter()
                a, b, fetch_stages = _prefetched(item).result()
                t_loaded = time.perf_counter()
            metrics = fused_evaluate(
                a, b, color_scheme=color_scheme,
                point_to_plane=point_to_plane, d2_mode=d2_mode,
                backend=backend, peak=peak,
            )
            wall = time.perf_counter() - t0
            rec["metrics"] = {
                k: (v.tolist() if hasattr(v, "tolist") else float(v))
                for k, v in metrics.items()
            }
            rec["wall_s"] = round(wall, 4)
            rec["mpoints_per_sec"] = round(
                mpoints_per_sec(a.n + b.n, wall), 4
            )
            rec["stages"] = dict(
                fetch_stages,
                load_wait_s=round(t_loaded - t0, 4),
                eval_s=round(wall - (t_loaded - t0), 4),
            )
        except Exception as e:  # skip-and-log per file
            logger.exception("frame %s failed", item.tag)
            rec["error"] = f"{type(e).__name__}: {e}"
        return rec

    results = []
    try:
        with open(journal_path, "a") as journal:
            for item in items:
                if item.tag in done:
                    logger.info("skip %s (already in journal)", item.tag)
                    results.append(done[item.tag])
                    continue
                with span("pcc.pair", pair=pair_ids[item.tag]):
                    rec = _evaluate(item)
                    journal.write(json.dumps(rec) + "\n")
                    journal.flush()
                results.append(rec)
    finally:
        prefetcher.shutdown(wait=True, cancel_futures=True)
    return results


def run_sweep_sharded(
    items: typing.Sequence[SweepItem],
    journal_path: str,
    mesh=None,
    dp: typing.Optional[int] = None,
    color_scheme: typing.Optional[str] = None,
    point_to_plane: bool = False,
    d2_mode: str = "reference",
    dtype: str = "float32",
    resume: bool = True,
    prune: bool = True,
    peak: typing.Optional[float] = None,
) -> typing.List[dict]:
    """Multi-device sweep: dp frames a step over a ("frames", "points")
    mesh (``parallel.sharded``).

    The frames of a group are padded to one common size; the ring evaluates
    them with frame groups over the mesh rows and each cloud's points over a
    row's slots. ``mesh`` None means every CUDA device (``make_mesh``, which
    raises without one), in ``dp`` rows: by default 2 when the device count
    is even and at least 4, else 1. ``prune`` (the default) runs the pruned
    ring through ``sharded_pair_stats_pruned_auto``'s ladder: caps 16 and
    64, as the JAX package tries, then on by 4x up to a slot's chunk count,
    where no step can overflow, so every group ends exact; the rung that
    settled is remembered per shape. The JAX package instead gives a group
    still overflowing at cap 64 to the brute ring, whose plain search costs
    minutes a group at 800k points; ``prune=False`` runs the brute ring.
    Clouds are loaded onto slot (0, 0)'s device and the OBB peak is swept
    there when it is a CUDA device, in numpy otherwise.
    """
    from .cloud import Cloud
    from .io import read_point_cloud
    from .ops.fused import _to_host, finalize_stats
    from .ops.obb import minimal_obb_extent
    from .parallel.sharded import (
        make_mesh, pack_sorted_frames, sharded_pair_stats,
        sharded_pair_stats_pruned_auto)

    if mesh is None:
        n_dev = torch.cuda.device_count()
        dp = dp or (2 if n_dev % 2 == 0 and n_dev >= 4 else 1)
        mesh = make_mesh(dp=dp)
    dp, sp = mesh.devices.shape
    device = mesh.devices[0, 0]
    obb_device = device if device.type == "cuda" else False
    torch_dtype = {"float32": torch.float32, "float64": torch.float64}[dtype]

    done = _read_journal(journal_path) if resume else {}
    todo = [it for it in items if it.tag not in done]
    results = [done[it.tag] for it in items if it.tag in done]

    with open(journal_path, "a") as journal:
        for g in range(0, len(todo), dp):
            group = todo[g:g + dp]
            real = len(group)
            while len(group) < dp:  # repeat the last frame to fill the group
                group = group + [group[-1]]
            raws = [(it, read_point_cloud(it.ocloud),
                     read_point_cloud(it.pcloud)) for it in group]
            pad = max(pad_bucket(max(ro.n, rp.n)) for _, ro, rp in raws)
            pad = -(-pad // (sp * 256)) * (sp * 256)

            t0 = time.perf_counter()

            def load(raw):
                return Cloud.from_numpy(raw.points, colors=raw.colors,
                                        normals=raw.normals,
                                        dtype=torch_dtype, pad_to=pad,
                                        device=device)

            a_list = [load(ro) for _, ro, _ in raws]
            b_list = [load(rp) for _, _, rp in raws]
            if prune:
                # The bound-pruned ring over sorted shards refines only the
                # qualifying Morton chunks; its ladder climbs from cap 16.
                stats = _to_host(sharded_pair_stats_pruned_auto(
                    mesh, pack_sorted_frames(
                        a_list, b_list, color_scheme=color_scheme,
                        point_to_plane=point_to_plane, d2_mode=d2_mode),
                    color_scheme=color_scheme, point_to_plane=point_to_plane,
                    d2_mode=d2_mode, cap=16))
                stats.pop("nn_overflow")
            else:
                kw = {}
                if color_scheme is not None:
                    kw["a_col"] = torch.stack([c.colors for c in a_list])
                    kw["b_col"] = torch.stack([c.colors for c in b_list])
                if point_to_plane and all(
                        c.normals is not None for c in a_list + b_list):
                    kw["a_nrm"] = torch.stack([c.normals for c in a_list])
                    kw["b_nrm"] = torch.stack([c.normals for c in b_list])
                stats = _to_host(sharded_pair_stats(
                    mesh,
                    torch.stack([c.points for c in a_list]),
                    torch.stack([c.points for c in b_list]),
                    [c.n for c in a_list], [c.n for c in b_list],
                    color_scheme=color_scheme,
                    point_to_plane=point_to_plane, d2_mode=d2_mode, **kw))
            wall = time.perf_counter() - t0

            for f, (it, ro, _) in enumerate(raws[:real]):
                extent_peak = (
                    float(np.max(minimal_obb_extent(ro.points,
                                                    device=obb_device)))
                    if peak is None else float(peak))
                metrics = finalize_stats(
                    {k: v[f] for k, v in stats.items()}, extent_peak,
                    color_scheme=color_scheme,
                    point_to_plane=point_to_plane, peak=peak)
                rec = {
                    "tag": it.tag, "ocloud": it.ocloud, "pcloud": it.pcloud,
                    "ts": time.time(),
                    "metrics": {
                        k: (v.tolist() if hasattr(v, "tolist") else float(v))
                        for k, v in metrics.items()
                    },
                    "wall_s": round(wall, 4),
                    "group_mpoints_per_sec": round(mpoints_per_sec(
                        sum(c.n for c in a_list + b_list), wall), 4),
                }
                journal.write(json.dumps(rec) + "\n")
                journal.flush()
                results.append(rec)
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m open_pcc_metric_tpu_torch.batch",
        description="Evaluate a sequence of cloud pairs with journal + resume.")
    p.add_argument("--manifest", default=None,
                   help="CSV manifest: ocloud,pcloud[,tag] per line.")
    p.add_argument("--ocloud-dir", default=None)
    p.add_argument("--pcloud-dir", default=None)
    p.add_argument("--journal", required=True,
                   help="JSONL journal path (append + resume).")
    p.add_argument("--color", choices=["rgb", "ycc", "yuv"], default=None)
    p.add_argument("--point-to-plane", action="store_true")
    p.add_argument("--d2-mode", choices=["reference", "pc_error"],
                   default="reference", help="(default: reference)")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32", help="(default: float32)")
    p.add_argument("--backend", choices=list(BACKENDS), default="auto",
                   help="NN backend (default: auto); the ring of --sharded "
                        "has its own, so only auto goes with it.")
    p.add_argument("--peak", "--resolution", type=float, default=None,
                   help="User-supplied geometric-PSNR peak (pc_error's "
                        "--resolution convention).")
    p.add_argument("--no-resume", action="store_true",
                   help="Re-evaluate frames already in the journal.")
    p.add_argument("--device", default="cuda",
                   help="Torch device to evaluate on (default: cuda).")
    p.add_argument("--sharded", action="store_true",
                   help="Evaluate frame groups on a (frames x points) mesh: "
                        "with --device cuda every CUDA device, else --dp "
                        "slots of --device, one a frame group.")
    p.add_argument("--dp", type=int, default=None,
                   help="Frame groups in sharded mode.")
    return p


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sharded and args.backend != "auto":
        parser.error("--backend does not apply to --sharded (the ring "
                     "searches with its own pruned or brute ring)")
    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        parser.error(f"--device {args.device!r}: {e}")
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to evaluate on the CPU)")
    if args.manifest:
        items = pairs_from_manifest(args.manifest)
    elif args.ocloud_dir and args.pcloud_dir:
        items = pairs_from_dirs(args.ocloud_dir, args.pcloud_dir)
    else:
        parser.error("provide --manifest or --ocloud-dir/--pcloud-dir")
    kw = dict(color_scheme=args.color, point_to_plane=args.point_to_plane,
              d2_mode=args.d2_mode, dtype=args.dtype,
              resume=not args.no_resume, peak=args.peak)
    if args.sharded:
        from .parallel.sharded import make_mesh

        mesh = None
        if device != torch.device("cuda"):
            mesh = make_mesh(devices=[device] * (args.dp or 1),
                             dp=args.dp or 1)
        results = run_sweep_sharded(items, args.journal, mesh=mesh,
                                    dp=args.dp, **kw)
    else:
        results = run_sweep(items, args.journal, backend=args.backend,
                            device=device, **kw)
    ok = sum(1 for r in results if "error" not in r)
    print(f"{ok}/{len(results)} frames evaluated -> {args.journal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
