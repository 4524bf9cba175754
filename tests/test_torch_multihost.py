"""PyTorch port: ``parallel/multihost.py`` on ``torch.distributed``.

The round-robin split, the journal shard paths and the merge are held
against the JAX package's functions; ``init()`` without a configured
coordinator stays standalone and quiet; ``init()`` with the JAX package's
keywords joins a one-process group and refuses any keyword that neither
package's initialiser knows; and one two-process gloo run
(spawned inside a subprocess with a time limit) shards a real CPU sweep by
each process's rank and merges a complete, disjoint journal.
"""
import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

from open_pcc_metric_tpu_torch.batch import SweepItem
from open_pcc_metric_tpu_torch.parallel import multihost

from test_torch_refine import jax_on_cpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shard_items_path_and_merge_match_jax(tmp_path):
    jax_on_cpu()
    from open_pcc_metric_tpu.parallel import multihost as jmultihost

    items = [SweepItem(f"o{i}", f"p{i}", tag=f"t{i}") for i in range(11)]
    for count in (1, 3, 4):
        shards = [multihost.shard_items(items, index=i, count=count)
                  for i in range(count)]
        assert shards == [jmultihost.shard_items(items, index=i, count=count)
                          for i in range(count)]
        got = sorted(it.tag for sh in shards for it in sh)
        assert got == sorted(it.tag for it in items)  # complete
        assert sum(len(s) for s in shards) == len(items)  # disjoint
    shards = [multihost.shard_items(items, index=i, count=3) for i in range(3)]
    assert [it.tag for it in shards[1]] == ["t1", "t4", "t7", "t10"]

    base = str(tmp_path / "out.jsonl")
    for i in range(3):
        p = multihost.shard_path(base, index=i)
        assert p == jmultihost.shard_path(base, index=i)
        assert p.endswith(f".h{i}.jsonl")
        with open(p, "w") as f:
            for it in shards[i]:
                f.write(json.dumps({"tag": it.tag}) + "\n")
    merged = multihost.merge_journals(base, count=3)
    with open(merged) as f:
        text = f.read()
    tags = sorted(json.loads(line)["tag"] for line in text.splitlines())
    assert tags == sorted(it.tag for it in items)
    jbase = str(tmp_path / "jax" / "out.jsonl")
    os.makedirs(os.path.dirname(jbase))
    for i in range(3):
        os.replace(multihost.shard_path(base, i),
                   jmultihost.shard_path(jbase, i))
    with open(jmultihost.merge_journals(jbase, count=3)) as f:
        assert f.read() == text


def test_init_standalone_is_quiet(monkeypatch, capfd):
    """No RANK/WORLD_SIZE and no rank/world_size given: init() joins no
    group, waits for nobody and prints nothing; the index and count are a
    single process's."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    capfd.readouterr()
    multihost.init()
    multihost.init(backend="gloo")
    assert not dist.is_initialized()
    assert capfd.readouterr() == ("", "")
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.shard_path("out.jsonl") == "out.h0.jsonl"
    assert multihost.shard_items([1, 2, 3]) == [1, 2, 3]


def test_init_takes_jax_keywords(monkeypatch):
    """``coordinator_address``, ``num_processes`` and ``process_id`` (the
    JAX package's ``init`` keywords) join a gloo group of world size 1 and
    rank 0 through a TCP rendezvous at that address; ``timeout`` (an
    ``init_process_group`` keyword) bounds the join."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    try:
        multihost.init(coordinator_address=f"127.0.0.1:{_free_port()}",
                       num_processes=1, process_id=0, backend="gloo",
                       timeout=datetime.timedelta(seconds=60))
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        assert (multihost.process_index(), multihost.process_count()) == (
            0, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_init_refuses_unknown_keywords():
    """A keyword that is neither the JAX package's nor
    ``init_process_group``'s raises TypeError, as does one given under both
    names or a positional backend; none of them joins a group."""
    with pytest.raises(TypeError, match="bogus"):
        multihost.init(bogus=1)
    with pytest.raises(TypeError, match="world_size"):
        multihost.init(num_processes=1, world_size=1)
    with pytest.raises(TypeError):
        multihost.init("gloo")
    assert not dist.is_initialized()


_TWO_PROCESS = textwrap.dedent("""
    import json, os, sys
    import torch.multiprocessing as mp

    def run(rank, port, root, items):
        os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        import torch.distributed as dist
        from open_pcc_metric_tpu_torch.batch import SweepItem, run_sweep
        from open_pcc_metric_tpu_torch.parallel import multihost

        multihost.init()
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert (multihost.process_index(), multihost.process_count()) == (
            rank, 2)
        base = os.path.join(root, "out.jsonl")
        mine = multihost.shard_items([SweepItem(*it) for it in items])
        run_sweep(mine, multihost.shard_path(base), device="cpu")
        dist.barrier()
        if rank == 0:
            multihost.merge_journals(base)
        dist.destroy_process_group()

    if __name__ == "__main__":
        port, root, items = int(sys.argv[1]), sys.argv[2], json.loads(
            sys.argv[3])
        mp.spawn(run, args=(port, root, items), nprocs=2, join=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_sweep(tmp_path):
    from open_pcc_metric_tpu_torch.io import write_ply

    rng = np.random.default_rng(4)
    items = []
    for f in range(5):
        pts = np.unique(rng.integers(0, 64, (300, 3)), axis=0).astype(float)
        o, p = tmp_path / f"o{f}.ply", tmp_path / f"p{f}.ply"
        write_ply(str(o), pts)
        write_ply(str(p), pts + rng.integers(-1, 2, pts.shape))
        items.append((str(o), str(p), f"frame{f}"))
    script = tmp_path / "two.py"
    script.write_text(_TWO_PROCESS)
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, str(script), str(_free_port()), str(tmp_path),
         json.dumps(items)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-4000:]
    shards = []
    for rank in range(2):
        with open(tmp_path / f"out.h{rank}.jsonl") as f:
            shards.append([json.loads(line)["tag"] for line in f])
    assert shards == [["frame0", "frame2", "frame4"], ["frame1", "frame3"]]
    with open(tmp_path / "out.jsonl") as f:
        merged = [json.loads(line) for line in f]
    assert sorted(r["tag"] for r in merged) == [f"frame{f}" for f in range(5)]
    assert all("metrics" in r for r in merged)
