"""Multi-host sweep utilities on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/multihost.py``. Frames are
embarrassingly parallel, so hosts coordinate through ``torch.distributed``
(control plane) and write disjoint journal shards (data plane).

Typical use, with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set in each process's environment (or the JAX package's
``init(coordinator_address=..., num_processes=..., process_id=...)``):

    from open_pcc_metric_tpu_torch.parallel import multihost
    multihost.init()                      # torch.distributed process group
    mine = multihost.shard_items(items)   # this process's frames
    run_sweep(mine, journal_path=multihost.shard_path("out.jsonl"))

Journals merge by concatenation (each record is self-describing JSONL).
"""
from __future__ import annotations

import inspect
import os
import typing

from ..utils.logging import get_logger


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def _initialized() -> bool:
    dist = _dist()
    return dist is not None and dist.is_initialized()


# The JAX package's ``init`` passes its keywords to
# ``jax.distributed.initialize``; these name what ``init_process_group``'s
# do (a coordinator "host:port" is its TCP rendezvous).
_JAX_KEYWORDS = {"coordinator_address": "init_method",
                 "num_processes": "world_size", "process_id": "rank"}


def _group_kwargs(dist, kwargs: dict) -> dict:
    """``kwargs`` in ``init_process_group``'s names; TypeError for a
    keyword that is neither the JAX package's nor ``init_process_group``'s,
    or for one given under both names."""
    known = {name for name in inspect.signature(
        dist.init_process_group).parameters
        if name != "backend" and not name.startswith("_")}
    out = {}
    for name, value in kwargs.items():
        key = _JAX_KEYWORDS.get(name, name)
        if key not in known:
            raise TypeError(f"init() got an unexpected keyword argument "
                            f"{name!r}")
        if key in out:
            raise TypeError(f"init() got {key!r} twice (as {name!r} too)")
        if name == "coordinator_address" and "://" not in value:
            value = f"tcp://{value}"
        out[key] = value
    return out


def init(*, backend: typing.Optional[str] = None, **kwargs) -> None:
    """Join the ``torch.distributed`` process group (a no-op when
    single-process or already joined).

    ``kwargs`` are the JAX package's (``coordinator_address``,
    ``num_processes``, ``process_id``, which become ``init_method=
    "tcp://..."``, ``world_size`` and ``rank``) or ``init_process_group``'s
    (``timeout``, for one); any other keyword raises TypeError.
    ``backend``: NCCL when a CUDA device is present and gloo otherwise,
    unless named. A process with no coordinator configured (neither
    ``RANK`` and ``WORLD_SIZE`` in the environment nor a rank and a world
    size given) stays standalone, quietly, and never waits for peers; so
    does one whose configuration ``init_process_group`` rejects.
    """
    dist = _dist()
    if dist is None:
        return
    kwargs = _group_kwargs(dist, kwargs)
    if dist.is_initialized():
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
