"""Multi-host sweep utilities on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/multihost.py``. Frames are
embarrassingly parallel, so hosts coordinate through ``torch.distributed``
(control plane) and write disjoint journal shards (data plane).

Typical use, with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set in each process's environment:

    from open_pcc_metric_tpu_torch.parallel import multihost
    multihost.init()                      # torch.distributed process group
    mine = multihost.shard_items(items)   # this process's frames
    run_sweep(mine, journal_path=multihost.shard_path("out.jsonl"))

Journals merge by concatenation (each record is self-describing JSONL).
"""
from __future__ import annotations

import os
import typing

from ..utils.logging import get_logger


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def _initialized() -> bool:
    dist = _dist()
    return dist is not None and dist.is_initialized()


def init(backend: typing.Optional[str] = None, **kwargs) -> None:
    """Join the ``torch.distributed`` process group (a no-op when
    single-process or already joined).

    ``backend``: NCCL when a CUDA device is present and gloo otherwise,
    unless named. ``kwargs`` go to ``init_process_group``. A process with
    no coordinator configured (neither ``RANK`` and ``WORLD_SIZE`` in the
    environment nor ``rank`` and ``world_size`` given) stays standalone,
    quietly, and never waits for peers; so does one whose configuration
    ``init_process_group`` rejects.
    """
    dist = _dist()
    if dist is None or dist.is_initialized():
        return
    configured = (("RANK" in os.environ and "WORLD_SIZE" in os.environ)
                  or ("rank" in kwargs and "world_size" in kwargs))
    if not configured:
        get_logger().debug("no torch.distributed coordinator configured; "
                           "standalone")
        return
    if backend is None:
        import torch

        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        dist.init_process_group(backend=backend, **kwargs)
    except (ValueError, RuntimeError) as e:
        get_logger().debug("torch.distributed not initialised (%s); "
                           "standalone", e)


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def shard_items(items: typing.Sequence, index: typing.Optional[int] = None,
                count: typing.Optional[int] = None) -> list:
    """Round-robin split of sweep items across hosts (deterministic)."""
    i = process_index() if index is None else index
    c = process_count() if count is None else count
    return [item for j, item in enumerate(items) if j % c == i]


def shard_path(path: str, index: typing.Optional[int] = None) -> str:
    """Per-host journal path: out.jsonl -> out.h<k>.jsonl."""
    i = process_index() if index is None else index
    root, ext = os.path.splitext(path)
    return f"{root}.h{i}{ext}"


def merge_journals(path: str, count: typing.Optional[int] = None) -> str:
    """Concatenate per-host journal shards into the base path."""
    c = process_count() if count is None else count
    with open(path, "w") as out:
        for i in range(c):
            p = shard_path(path, i)
            if os.path.exists(p):
                with open(p) as f:
                    out.write(f.read())
    return path
