"""PyTorch port: the k-NN certificate tiers, the escalation ladder and the
brute-force k-NN against the JAX package.

Tier B is reached only when a tile qualifies more than tier A's 128
chunks, so its test pairs one spread-out query tile with a 136-chunk
search cloud (as test_torch_nn_pruned.py does for the 1-NN). The ladder
test climbs from cap 1 through ``knn_pruned``; the JAX side's own
``knn_pruned`` runs its XLA schedule on the CPU, which certifies at the
same rungs (both stage-1 forms refine every chunk that can hold a
neighbour, so the k-th distances and counts agree).
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops import knn_pruned as kp
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.knn import knn
from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned_sorted

from test_torch_knn_pruned import K, _grid, _int_points, assert_matches, \
    jax_knn_sorted
from test_torch_refine import jax_on_cpu


def test_tiers_a_and_b_match_jax():
    """One query tile spread over the whole search cloud qualifies every
    one of its 136 chunks: stage 1 (cap 12) overflows, tier A (128) cannot
    cover it, tier B (136) certifies, and the moments extend through both
    tiers."""
    a, ga = _grid(_int_points(100, 23, 512), pad_to=8 * CHUNK)
    b, gb = _grid(_int_points(34000, 24, 512), pad_to=136 * CHUNK)
    assert gb.n_chunks == 136
    assert bool(knn_pruned_sorted(ga, gb, a.n, K, cap=12, fallback_tiles=0)[2])
    kw = dict(cap=12, fallback_tiles=128, with_moments=True)
    got = knn_pruned_sorted(ga, gb, a.n, K, **kw)
    want = jax_knn_sorted(ga, gb, a.n, **kw)
    assert not want[2]
    assert_matches(got, want, a.n)
    # against a float64 brute force with lowest-original-id ties
    q = ga.points[: a.n].double().numpy()
    d = ((q[:, None, :] - b.host_points[None]) ** 2).sum(-1)
    ids = np.broadcast_to(np.arange(b.n), d.shape)
    order = np.lexsort((ids, d), axis=1)
    np.testing.assert_array_equal(got[1][: a.n].numpy(), order[:, :K])


def test_escalation_from_tiny_cap_matches_jax():
    """cap=1, fallback=1 overflows; ``knn_pruned`` climbs the ladder to the
    rung the JAX package certifies at and returns its exact (idx, d) in
    original row order."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops import knn_pruned as jkp

    pts = _int_points(2000, 21, 40)
    c = Cloud.from_numpy(pts, pad_to=2048, device="cpu")
    key = (2048, 2048, 10, False)
    kp._ESCALATION_MEMO.pop(key, None)
    jkp._ESCALATION_MEMO.pop(key, None)
    idx, d = kp.knn_pruned(c.points, c.points, c.n, c.n, k=10, cap=1,
                           fallback_tiles=1)
    jidx, jd = jkp.knn_pruned(jnp.asarray(c.points.numpy()),
                              jnp.asarray(c.points.numpy()), c.n, c.n, k=10,
                              cap=1, fallback_tiles=1)
    np.testing.assert_array_equal(idx[: c.n].numpy(), np.asarray(jidx)[: c.n])
    np.testing.assert_array_equal(d[: c.n].numpy(), np.asarray(jd)[: c.n])
    rung = kp._ESCALATION_MEMO[key][0]
    assert rung == jkp._ESCALATION_MEMO[key][0] and rung != (1, 1)
    # row r holds the 10 nearest of point r, ties to the lower id
    dd = ((pts[:, None, :] - pts[None]) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(c.n), dd.shape), dd), axis=1)
    np.testing.assert_array_equal(idx[: c.n].numpy(), order[:, :10])


def test_brute_knn_matches_jax():
    """The brute force on an integer cloud with many ties, with and without
    self exclusion, against the JAX package's running top-k merge."""
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.knn import knn as jknn

    rng = np.random.default_rng(5)
    a = rng.integers(0, 12, (600, 3)).astype(np.float32)
    b = rng.integers(0, 12, (1024, 3)).astype(np.float32)
    for q, s, ex in ((a, b, False), (b, b, True)):
        idx, d = knn(torch.from_numpy(q), torch.from_numpy(s), 30,
                     exclude_self=ex)
        jidx, jd = jknn(jnp.asarray(q), jnp.asarray(s), k=30, exclude_self=ex)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        assert np.mean(np.diff(d.numpy(), axis=1) == 0) > 0.3  # ties abound


# Each ladder's base rung and (max_cap, max_ft) limits at a shape of its
# own: the stepwise fused ladder and boundary_stats (n_chunks, n_chunks),
# nn_pruned (ncb, nta), knn_pruned (ncb, nta), the estimation (ncb,
# p // CHUNK).
LADDERS = {"fused": ((32, 256), (3328, 3328)),
           "nn_pruned": ((32, 128), (1920, 3328)),
           "knn_pruned": ((64, 256), (300, 40)),
           "normals": ((64, 256), (3328, 3328))}


def _rungs(base, max_cap, max_ft, n):
    """The first n rungs from base by next_rung, stopping at max_cap."""
    from open_pcc_metric_tpu_torch.utils.cache import next_rung

    out = [base]
    while len(out) < n and out[-1][0] < max_cap:
        out.append(next_rung(*out[-1], max_cap, max_ft))
    return out


@pytest.mark.parametrize("hold", [0, 2, 99])
@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_climb_rungs_and_memo(ladder, hold):
    """``utils.cache.climb`` with a fake run that overflows on the first
    ``hold`` rungs of next_rung's sequence: it tries those rungs from the
    base in order and returns the first that certifies, or the first at
    cap >= max_cap even while that overflows (hold 99). With a memo it
    stores that rung as ladder_store does and starts the next call there;
    after 64 uses it retries the base rung once, which overflows and
    re-climbs to the same rung."""
    from open_pcc_metric_tpu_torch.utils.cache import climb

    base, (max_cap, max_ft) = LADDERS[ladder]
    want = _rungs(base, max_cap, max_ft, hold + 1)
    tried = []

    def run(cap, ft):
        tried.append((cap, ft))
        return len(tried), (cap, ft) in want[:hold]

    result, rung = climb(run, base, max_cap, max_ft)
    assert tried == want and rung == want[-1] and result == len(want)
    if hold == 99:
        assert rung[0] >= max_cap > want[-2][0]
    memo, key = {}, ("shape", ladder)
    del tried[:]
    assert climb(run, base, max_cap, max_ft, memo, key)[1] == rung
    assert tried == want and memo == {key: (rung, 0)}
    del tried[:]
    assert climb(run, base, max_cap, max_ft, memo, key)[1] == rung
    assert tried == [rung] and memo == {key: (rung, 1)}
    memo[key] = (rung, 64)
    del tried[:]
    assert climb(run, base, max_cap, max_ft, memo, key)[1] == rung
    if rung == base:  # nothing to retry: the use is counted
        assert tried == [base] and memo == {key: (base, 65)}
    else:
        assert tried == want and memo == {key: (rung, 1)}
