"""PyTorch port: the certificate-bucketed 1-NN (``nn_pruned_bucketed_sorted``)
against the port's ``nn_pruned_sorted`` and the JAX package's plain route,
the mirror of tests/test_pallas.py's bucketed cases.

Whenever the schedule's overflow flag is clear, its distances and ids equal
the default schedule's bit for bit, ties included; when it is set, the
caller falls back, so exactness is never lost silently. Spies show the
passes (probe, B1, tiers) and that each is K1 over global tile ids. The
``cuda`` case runs the schedule's K1 launches on the card.
"""
import os

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import nn_pruned as nnp
from open_pcc_metric_tpu_torch.ops.nn_pruned import (
    nn_pruned_bucketed_sorted, nn_pruned_sorted)
from open_pcc_metric_tpu_torch.ops.refine import refine_nn

from test_torch_refine import jax_on_cpu


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """A worker's share of torch's threads under pytest-xdist (as
    test_torch_sharded.py takes it)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


def _clouds(seed, hi, na=4000, nb=3300, device="cpu"):
    rng = np.random.default_rng(seed)
    a = Cloud.from_numpy(rng.integers(0, hi, (na, 3)).astype(float),
                         device=device)
    b = Cloud.from_numpy(rng.integers(0, hi, (nb, 3)).astype(float),
                         device=device)
    return a, b, a.get_grid(build="device"), b.get_grid(build="device")


def _jax_plain(ga, gb, n_a):
    """The JAX package's ``nn_pruned_sorted(refine_impl="xla")`` on the
    same grid."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.grid import ChunkGrid as JGrid
    from open_pcc_metric_tpu.ops.nn_pruned import nn_pruned_sorted as jnn

    def jg(g):
        return JGrid(*(jnp.asarray(x.numpy()) for x in g))

    d, i, _ = jnn(jg(ga), jg(gb), jnp.asarray(n_a), refine_impl="xla")
    return np.asarray(d), np.asarray(i)


def _equal(got, want, n):
    for x, y in zip(got[:2], want[:2]):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        if not np.array_equal(x[:n], y[:n]):
            return False
    return True


def _spy(monkeypatch):
    calls = []
    real = nnp.refine_nn

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(nnp, "refine_nn", spy)
    return calls


@pytest.mark.parametrize("seed,hi", [(42, 512), (7, 24)])
def test_bucketed_schedule_bitexact(seed, hi, monkeypatch):
    """Sparse (seed 42, [0, 512)^3) and tie-heavy dense (seed 7, [0, 24)^3)
    integer clouds: equal to ``nn_pruned_sorted`` and to the JAX package's
    plain route whenever the flag is clear."""
    a, _, ga, gb = _clouds(seed, hi)
    calls = _spy(monkeypatch)
    got = nn_pruned_bucketed_sorted(ga, gb, a.n)
    # the probe (all tiles, no ids) then every pass over global tile ids
    assert calls[0][0][3].shape[1] == 8 and calls[0][1] == {}
    assert all(kw["tiles"].dtype == torch.int32 and "init" in kw
               for _, kw in calls[1:])
    want = nn_pruned_sorted(ga, gb, a.n)
    if bool(got[2]):
        # small clouds can exhaust the B1 budget: exactness is then not
        # claimed, and the caller falls back
        return
    assert _equal(got, want, a.n)
    assert _equal(got, _jax_plain(ga, gb, a.n), a.n)


def test_bucketed_small_probe_never_silently_inexact():
    """p1 = 1 drives nearly every tile through B1, beyond its budget on a
    tie-heavy cloud: whenever the flag is clear the rows are exact. A
    roomier probe certifies, and is exact."""
    a, _, ga, gb = _clouds(11, 64, 3000, 2500)
    want = nn_pruned_sorted(ga, gb, a.n)
    got = nn_pruned_bucketed_sorted(ga, gb, a.n, p1=1, b1_extra=63)
    assert _equal(got, want, a.n) or bool(got[2])
    got = nn_pruned_bucketed_sorted(ga, gb, a.n, p1=24, b1_extra=40)
    assert not bool(got[2])
    assert _equal(got, want, a.n)
    assert _equal(got, _jax_plain(ga, gb, a.n), a.n)


def test_bucketed_tiers_run_and_certify(monkeypatch):
    """A narrow B1 (p1 = 2, b1_extra = 2; 16 tiles, so B1's budget is every
    tile) leaves tiles for tier A: A runs, gated to each tile's count past
    w1 = 4, and the schedule certifies, equal to the default."""
    a, _, ga, gb = _clouds(42, 512)
    calls = _spy(monkeypatch)
    got = nn_pruned_bucketed_sorted(ga, gb, a.n, p1=2, b1_extra=2)
    assert len(calls) == 3  # probe, B1, tier A (cap2b = cap2a: no tier B)
    assert int(calls[2][1]["ncand"].max()) > 4
    assert not bool(got[2])
    assert _equal(got, nn_pruned_sorted(ga, gb, a.n), a.n)


def _surface_clouds(device, n=60000, seed=42):
    """A voxelised sphere of radius 200 (n points) and its copy quantised
    by 2, the workload's kind of pair: its tiles' counts stay within the
    bucketed schedule's budgets, where random cubes' would not."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(4 * n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pa = np.unique(np.round(v * 200.0 + 256.0), axis=0)
    pa = pa[rng.permutation(len(pa))[:n]]
    pb = np.unique(np.round(pa / 2.0) * 2.0, axis=0)
    a = Cloud.from_numpy(pa, device=device)
    b = Cloud.from_numpy(pb, device=device)
    return a, a.get_grid(build="device"), b.get_grid(build="device")


@pytest.mark.cuda
def test_cuda_bucketed_matches_default():
    """On the card, a 60000-point surface pair: the schedule's K1 launches
    give the rows of the default schedule (certified at its base rung) bit
    for bit at p1 8 and 24, both certified, and the plain versions' rows
    on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    a, ga, gb = _surface_clouds("cuda")
    want = nn_pruned_sorted(ga, gb, a.n, cap=32, fallback_tiles=256)
    assert not bool(want[2])
    gc, gbc = (type(g)(*(x.cpu() for x in g)) for g in (ga, gb))
    for p1 in (8, 24):
        before = refine_nn.launches
        got = nn_pruned_bucketed_sorted(ga, gb, a.n, p1=p1)
        assert refine_nn.launches > before
        assert not bool(got[2])
        plain = nn_pruned_bucketed_sorted(gc, gbc, a.n, p1=p1)
        for x, y, z in zip(got[:2], want[:2], plain[:2]):
            assert torch.equal(x[: a.n], y[: a.n])
            assert torch.equal(x[: a.n].cpu(), z[: a.n])
