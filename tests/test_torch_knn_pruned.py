"""PyTorch port: the pruned k-NN schedule (with its moments pass) against the
JAX package.

The JAX side runs ``knn_pruned_sorted(..., refine_impl="pallas_interpret")``,
which drives the count-gated schedule through the Pallas K3 and K4 kernels
in interpret mode (as tests/test_pruned.py does). Both packages get the
SAME grid (converted as in test_torch_nn_pruned.py). On integer clouds,
full of exact ties, d and id must agree bit for bit and the overflow flag
must agree; the moment sums agree within rtol=1e-6, atol=1e-4 with the
member count equal (exactly k on every valid row).
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.cloud import Cloud
from open_pcc_metric_tpu_torch.ops.grid import CHUNK
from open_pcc_metric_tpu_torch.ops.knn_pruned import knn_pruned_sorted
from open_pcc_metric_tpu_torch.ops.refine import knn_moments, refine_knn

from test_torch_refine import jax_on_cpu

K = 30


def _grid(pts, pad_to=None):
    c = Cloud.from_numpy(pts, pad_to=pad_to, device="cpu")
    return c, c.get_grid(build="device")


def jax_knn_sorted(ga, gb, n_a, k=K, **kw):
    jax_on_cpu()
    import jax.numpy as jnp
    from open_pcc_metric_tpu.ops.grid import ChunkGrid as JGrid
    from open_pcc_metric_tpu.ops.knn_pruned import knn_pruned_sorted as jknn

    def jg(g):
        return JGrid(*(jnp.asarray(x.numpy()) for x in g))

    ja = jg(ga)
    jb = ja if gb is ga else jg(gb)
    out = jknn(ja, jb, jnp.asarray(n_a), k, refine_impl="pallas_interpret",
               **kw)
    return tuple(np.asarray(x) for x in out)


def assert_matches(got, want, n_a, k=K):
    """d, id and overflow bit-equal; moments (when present) within the JAX
    package's tolerance, with exactly k members on every valid row."""
    assert bool(got[2]) == bool(want[2])
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(x.numpy()[:n_a], y[:n_a])
    if len(got) == 4:
        mom = got[3].numpy()[:n_a]
        np.testing.assert_array_equal(mom[:, 0], want[3][:n_a, 0])
        assert np.all(mom[:, 0] == k)
        np.testing.assert_allclose(mom, want[3][:n_a], rtol=1e-6, atol=1e-4)


def _int_points(n, seed, hi):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, (n, 3)).astype(np.float64)


@pytest.mark.parametrize("cap,ft", [(16, 32), (8, 64)])
def test_knn_pruned_sorted_with_moments_matches_jax(cap, ft):
    """Self k-NN (the estimation's) on 24 tiles: probe, gated extension
    (cap 16) or one stage-1 refine (cap 8), tier A, the moments pass."""
    a, ga = _grid(_int_points(6000, 41, 64), pad_to=24 * CHUNK)
    kw = dict(cap=cap, fallback_tiles=ft, with_moments=True)
    got = knn_pruned_sorted(ga, ga, a.n, K, **kw)
    want = jax_knn_sorted(ga, ga, a.n, **kw)
    assert not want[2]
    assert_matches(got, want, a.n)


def test_knn_helix_sparse_chunks_matches_jax():
    """Counted k-NN (k=8) on a line-structured integer cloud: later chunks
    add only a few candidates per query to warm buffers, with exact ties
    (the regime of test_pruned.py's helix test)."""
    rng = np.random.default_rng(23)
    n = 4000
    t = np.arange(n) * 0.11
    pts = np.stack([np.round(40 * np.cos(t)) + 64,
                    np.round(40 * np.sin(t)) + 64,
                    np.round(t)], axis=1).astype(float)
    pts += rng.integers(0, 2, pts.shape)
    a, ga = _grid(pts, pad_to=4096)
    kw = dict(cap=16, fallback_tiles=64)
    got = knn_pruned_sorted(ga, ga, a.n, 8, **kw)
    want = jax_knn_sorted(ga, ga, a.n, k=8, **kw)
    assert not want[2]
    assert_matches(got, want, a.n, k=8)


@pytest.mark.cuda
def test_cuda_schedule_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the k-NN kernels have no CPU mode")
    dev = torch.device("cuda")
    a, ga = _grid(_int_points(6000, 41, 64), pad_to=24 * CHUNK)
    kw = dict(cap=16, fallback_tiles=32, with_moments=True)
    want = knn_pruned_sorted(ga, ga, a.n, K, **kw)
    gd = type(ga)(*(x.to(dev) for x in ga))
    before = (refine_knn.launches, knn_moments.launches)
    got = knn_pruned_sorted(gd, gd, a.n, K, **kw)
    assert refine_knn.launches > before[0] and knn_moments.launches > before[1]
    for x, y in zip(got[:3], want[:3]):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(got[3][:, 0].cpu(), want[3][:, 0])
    torch.testing.assert_close(got[3].cpu(), want[3], rtol=1e-6, atol=1e-4)
