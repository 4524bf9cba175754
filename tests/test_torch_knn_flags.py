"""PyTorch port: the k-NN schedule flags (``knn_pruned.KnnFlags``) against
the JAX package.

``knn_flags_from_env`` parses the ``PCC_KNN_*`` environment as the JAX
package's does, field by field. The six flags that pick the JAX package's
TPU relayouts (need-sorted slices, two levels) change neither the results
nor the launches: one rectangular extension and one stage-1 moments
launch, as with the defaults. The plain route (``refine_impl="xla"``)
takes the fixed stage 1 and K4's moments and equals the JAX package's
plain route. The sort-based k-best that the plain K3 uses equals the
round-by-round one. Every case runs eager PyTorch on the CPU; the JAX side
runs its plain (XLA) route, no interpret-mode kernel. The ``cuda`` case
runs the same on the card.
"""
import os

import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import knn_pruned as kp
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.knn_pruned import (
    KnnFlags, knn_flags_from_env, knn_pruned_sorted)
from open_pcc_metric_tpu_torch.ops.refine import (
    INT_MAX, _extract_k, knn_moments, refine_knn, refine_knn_straight)

from test_torch_refine import jax_on_cpu

K = 8  # the schedules do not depend on k; the estimation's 30 below
K_EST = 30
CAP, FT = 16, 64
ENV_KNOBS = ("PCC_KNN_SCHED", "PCC_KNN_P1", "PCC_KNN_CS", "PCC_KNN_EXT_SLICE",
             "PCC_KNN_EXT_SORTED", "PCC_KNN_MOM_SORTED", "PCC_KNN_EXT_E1",
             "PCC_KNN_EXT_FTE", "PCC_KNN_PROLOGUE")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """A worker's share of torch's threads under pytest-xdist (as
    test_torch_sharded.py takes it)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- flags


def test_knn_flags_fields_and_defaults_match_jax():
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.knn_pruned import KnnFlags as JFlags

    assert KnnFlags._fields == JFlags._fields
    assert tuple(KnnFlags()) == tuple(JFlags())


@pytest.mark.parametrize("env", [
    {},
    {"PCC_KNN_SCHED": "fixed", "PCC_KNN_P1": "5", "PCC_KNN_CS": "2",
     "PCC_KNN_EXT_SLICE": "37", "PCC_KNN_EXT_SORTED": "1",
     "PCC_KNN_MOM_SORTED": "0", "PCC_KNN_EXT_E1": "3",
     "PCC_KNN_EXT_FTE": "9", "PCC_KNN_PROLOGUE": "select"},
    {"PCC_KNN_EXT_SLICE": "3", "PCC_KNN_MOM_SORTED": "true",
     "PCC_KNN_EXT_SORTED": "yes", "PCC_KNN_SCHED": "counted"},
], ids=["unset", "every-knob", "edges"])
def test_knn_flags_from_env_matches_jax(env, monkeypatch):
    """Unset, every knob set, and the parse's edges (a slice below 8, a
    flag set to something other than "1")."""
    jax_on_cpu()
    from open_pcc_metric_tpu.ops.knn_pruned import knn_flags_from_env as jenv

    for name in ENV_KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got, want = knn_flags_from_env(), jenv()
    assert got._asdict() == want._asdict()


def test_overrides_and_refine_impl(monkeypatch):
    """p1, prologue and sched replace their fields of the resolved flags;
    an unknown refine_impl raises."""
    monkeypatch.setenv("PCC_KNN_P1", "5")
    got = kp.resolve_knn_flags(p1=3, prologue="select", sched="fixed")
    assert (got.p1, got.prologue, got.sched) == (3, "select", "fixed")
    assert kp.resolve_knn_flags().p1 == 5
    with pytest.raises(ValueError):
        kp.resolve_knn_flags(sched="bogus")
    _, g = _cloud()
    with pytest.raises(ValueError, match="refine_impl"):
        knn_pruned_sorted(g, g, 10, 8, refine_impl="interpret")


# ---------------------------------------------------------------- k-best


def _extract_k_rounds(d: torch.Tensor, ids: torch.Tensor, k: int):
    """k rounds of (lexicographic minimum, mask it out) over the last axis:
    the ascending k smallest distinct (d, id) pairs. Masked entries become
    (inf, INT_MAX), so a row with fewer than k finite pairs ends in
    (inf, INT_MAX). The JAX package's ``_extract_k``, the reference for
    the port's ``refine._extract_k``."""
    out_d = d.new_empty(d.shape[:-1] + (k,))
    out_i = ids.new_empty(ids.shape[:-1] + (k,))
    for r in range(k):
        m = d.amin(dim=-1, keepdim=True)
        at_min = d == m
        ii = torch.where(at_min, ids, INT_MAX).amin(dim=-1, keepdim=True)
        hit = at_min & (ids == ii)
        d = d.masked_fill(hit, torch.inf)
        ids = ids.masked_fill(hit, INT_MAX)
        out_d[..., r] = m[..., 0]
        out_i[..., r] = ii[..., 0]
    return out_d, out_i


@pytest.mark.parametrize("cols,k", [(300, 30), (17, 30), (64, 1)])
def test_sorted_k_best_equals_rounds(cols, k):
    """Ties in d, repeated (d, id) pairs, +inf rows and rows narrower than
    k: the same pairs in the same order as the k rounds."""
    gen = torch.Generator().manual_seed(cols + k)
    d = torch.randint(0, 20, (2, 32, cols), generator=gen).float()
    ids = torch.randint(0, 50, (2, 32, cols), generator=gen,
                        dtype=torch.int32)
    inf = torch.rand(d.shape, generator=gen) < 0.2
    d = torch.where(inf, torch.inf, d)
    ids = torch.where(inf & (torch.rand(d.shape, generator=gen) < 0.8),
                      INT_MAX, ids)
    d[0, 0] = torch.inf
    ids[0, 0] = INT_MAX
    got, want = _extract_k(d, ids, k), _extract_k_rounds(d, ids, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------- schedules


def _cloud(n=3500, seed=17, tiles=16, hi=80):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, hi, (n, 3)).astype(np.float64)
    c = Cloud.from_numpy(pts, pad_to=tiles * CHUNK, device="cpu")
    return c, c.get_grid(build="device")


def _counting(monkeypatch, name):
    calls = []
    real = getattr(kp, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(kp, name, spy)
    return calls


def _run(c, g, flags, k=K, **kw):
    return knn_pruned_sorted(g, g, c.n, k, cap=CAP, fallback_tiles=FT,
                             with_moments=True, flags=flags, **kw)


def _assert_same(got, want):
    assert bool(got[2]) == bool(want[2])
    for x, y in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def rect():
    """The cloud, its grid, the default flags' outputs and their K3 and K4
    calls (tiles and widths)."""
    c, g = _cloud()
    calls = {"refine_knn": [], "knn_moments": []}
    real = {name: getattr(kp, name) for name in calls}

    def spy(name):
        def call(*args, **kw):
            calls[name].append(_shape_of(args, kw))
            return real[name](*args, **kw)
        return call

    for name in calls:
        setattr(kp, name, spy(name))
    try:
        out = _run(c, g, KnnFlags())
    finally:
        for name in calls:
            setattr(kp, name, real[name])
    return c, g, out, calls


def _shape_of(args, kw):
    """A K3 or K4 call's candidate table shape and whether it named tiles."""
    tiles = kw.get("tiles", args[7] if len(args) > 7 else None)
    return tuple(args[3].shape), tiles is not None


# The JAX package's relayouts, each set as it engages there on 16 tiles:
# need-sorted extension and moments in slices of 8 tiles, sorted moments
# alone, the two-level extension with a roomy and a tight tier budget, and
# two slots a step (which gates them off in the JAX package).
RELAYOUTS = {
    "sorted-slices": KnnFlags(ext_sorted=True, ext_slice=8),
    "sorted-moments": KnnFlags(ext_slice=8),
    "two-level-roomy": KnnFlags(ext_e1=2, ext_fte=24),
    "two-level-tight": KnnFlags(ext_e1=2, ext_fte=8),
    "rectangular-moments": KnnFlags(mom_sorted=False),
    "two-slots-a-step": KnnFlags(ext_cs=2, ext_sorted=True, ext_slice=8),
}


@pytest.mark.parametrize("name", list(RELAYOUTS))
def test_relayout_flags_keep_rectangular_launches(rect, name, monkeypatch):
    """Each relayout gives the default's distances, ids, overflow and
    moment sums bit for bit, through the same K3 and K4 calls: the probe,
    one rectangular extension, one stage-1 moments launch over every tile,
    then the tiers."""
    c, g, want, want_calls = rect
    k3 = _counting(monkeypatch, "refine_knn")
    k4 = _counting(monkeypatch, "knn_moments")
    _assert_same(_run(c, g, RELAYOUTS[name]), want)
    assert [_shape_of(*x) for x in k3] == want_calls["refine_knn"]
    assert [_shape_of(*x) for x in k4] == want_calls["knn_moments"]
    nta = g.points.shape[0] // CHUNK
    assert want_calls["refine_knn"][1] == ((nta, CAP - 8), False)
    assert want_calls["knn_moments"][0] == ((nta, CAP), False)


def test_plain_route_matches_jax(rect, monkeypatch):
    """``refine_impl="xla"``: JAX's plain route's schedule (stage 1 refines
    all cap candidates: K2c and K3b), with K4's moments as on the kernel
    route (its plain version here). At the estimation's k = 30, d, ids
    and overflow equal the JAX package's plain route and the moments equal
    its gathered ones within float32 summation order, as do the normals;
    at k = 8 the plain route's d, ids and overflow equal the kernel
    route's."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.grid import ChunkGrid as JGrid
    from open_pcc_metric_tpu.ops.knn_pruned import knn_pruned_sorted as jknn
    from open_pcc_metric_tpu.ops.normals import (
        normals_from_moments as jnormals)
    from open_pcc_metric_tpu_torch.ops.normals import normals_from_moments

    c, g, kernel, _ = rect
    k3b = _counting(monkeypatch, "refine_knn_straight")
    k4 = _counting(monkeypatch, "knn_moments")
    gather = _counting(monkeypatch, "gather_moments")
    kw = dict(cap=CAP, fallback_tiles=FT, refine_impl="xla",
              with_moments=True)
    flags = KnnFlags(ext_sorted=True, ext_slice=8)
    plain = knn_pruned_sorted(g, g, c.n, K, flags=flags, **kw)
    got = knn_pruned_sorted(g, g, c.n, K_EST, flags=flags, **kw)
    assert len(k3b) == 2 and len(k4) >= 2 and not gather
    jg = JGrid(*(jnp.asarray(x.numpy()) for x in g))
    want = [np.asarray(x) for x in jknn(jg, jg, jnp.asarray(c.n), K_EST,
                                        **kw)]
    n = c.n
    assert bool(got[2]) == bool(want[2])
    assert bool(plain[2]) == bool(kernel[2])
    for x, y, z, w in zip(got[:2], want[:2], plain[:2], kernel[:2]):
        np.testing.assert_array_equal(x[:n].numpy(), y[:n])
        assert torch.equal(z[:n], w[:n])
    np.testing.assert_allclose(got[3][:n].numpy(), want[3][:n], rtol=1e-6,
                               atol=1e-4)
    dots = (normals_from_moments(got[3][:n]).numpy()
            * np.asarray(jnormals(jnp.asarray(want[3][:n])))).sum(1)
    assert np.abs(dots).min() > 1 - 1e-5


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 and K4 have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_flags_and_plain_route(cuda_device):
    """On the card, the estimation's 30-NN at 256 tiles and cap 64: every
    relayout flag gives the default's results bit for bit, K4's sums
    included, with the same K3 and K4 launches; ``refine_impl="xla"``
    launches K3b and K4 (never the gather) and keeps the default's d and
    ids."""
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 400, (60000, 3)).astype(np.float64)
    c = Cloud.from_numpy(pts, pad_to=256 * CHUNK, device=cuda_device)
    g = c.get_grid(build="device")

    def run(flags, **kw):
        before = (refine_knn.launches, knn_moments.launches,
                  refine_knn_straight.launches)
        out = knn_pruned_sorted(g, g, c.n, K_EST, cap=64, fallback_tiles=64,
                                with_moments=True, flags=flags, **kw)
        return out, (refine_knn.launches - before[0],
                     knn_moments.launches - before[1],
                     refine_knn_straight.launches - before[2])

    want, launches = run(KnnFlags())
    assert launches[0] > 0 and launches[1] > 0
    for flags in (KnnFlags(ext_sorted=True, ext_slice=16),
                  KnnFlags(ext_slice=16), KnnFlags(mom_sorted=False),
                  KnnFlags(ext_e1=8), KnnFlags(ext_e1=8, ext_fte=8)):
        got, got_launches = run(flags)
        _assert_same(got, want)
        assert got_launches == launches
    plain, plain_launches = run(KnnFlags(), refine_impl="xla")
    assert plain_launches[1] > 0 and plain_launches[2] == 1
    n = c.n
    assert torch.equal(plain[0][:n], want[0][:n])
    assert torch.equal(plain[1][:n], want[1][:n])
