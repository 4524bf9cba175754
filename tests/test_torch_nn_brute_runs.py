"""PyTorch port: K5's (the brute-force 1-NN's) run-min scan and split.

The CUDA K5 (``nn_argmin``) scans b's rows in runs of a few rows in
increasing j: each query row takes the run's minimum distance with one
``fminf`` a pair and only when that minimum is strictly below its best
looks for the lowest j of the run at the minimum. Each query row's best
starts at the first row of its range. b's rows are cut into ``split_count``
balanced ranges (``split_ranges``, ``pcc::split_begin``), one block each,
merged by the lexicographic (d, j) minimum.

On the CPU these tests hold a plain-torch model of that scan and split to
``nn_chunked`` bit for bit in index and distance, on integer clouds full of
ties and on float clouds, with and without ``exclude_self``. The tests
marked ``cuda`` hold the kernel at every row count it is built for, at
aligned and ragged row counts, to ``nn_chunked`` on the card.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch.ops import nn
from open_pcc_metric_tpu_torch.ops.nn import nn_argmin, nn_chunked
from open_pcc_metric_tpu_torch.ops.refine import _offsets, split_ranges


def _cloud(kind, n, seed, hi=12, dup=1):
    """n points in [0, hi)^3, integer or float, each point ``dup`` times
    (exactly tied distances), as float32."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        base = rng.integers(0, hi, (n // dup, 3)).astype(np.float64)
    else:
        base = rng.uniform(0.0, hi, (n // dup, 3))
    pts = np.concatenate([base] * dup)[rng.permutation(n // dup * dup)]
    return torch.from_numpy(pts).float()


def run_min_nn(a, b, run, splits, exclude_self=False):
    """K5's model: per split range [j0, j1) of b's rows, each query row's
    best starts at (d(j0), j0); the range is scanned in runs of ``run``
    rows (the last padded with d = inf), and a run whose minimum is
    strictly below the best gives (that minimum, its lowest j in the run).
    The ranges' bests are merged by the lexicographic (d, j) minimum in
    rank order. Returns (idx, dist) as nn_chunked."""
    na, nb = a.shape[0], b.shape[0]
    d_all = _offsets(a[None], b[None, None])[3][0]  # (na, nb)
    rows = torch.arange(na)
    if exclude_self:
        own = rows[:, None] == torch.arange(nb)[None, :]
        d_all = d_all.masked_fill(own, torch.inf)
    best_d = best_i = None
    for lo, hi in split_ranges(torch.tensor([nb]), splits):
        j0, j1 = int(lo), int(hi)
        bd, bi = d_all[:, j0].clone(), torch.full((na,), j0, dtype=torch.int32)
        for j in range(j0, j1, run):
            block = d_all[:, j:min(j + run, j1)]
            if block.shape[1] < run:
                block = torch.cat([block, torch.full(
                    (na, run - block.shape[1]), torch.inf)], 1)
            rmin = block.amin(1)
            at = (block == rmin[:, None]).int().argmax(1)  # the lowest s
            take = rmin < bd
            bd = torch.where(take, rmin, bd)
            bi = torch.where(take, (j + at).int(), bi)
        if best_d is None:
            best_d, best_i = bd, bi
        else:
            keep = (best_d < bd) | ((best_d == bd) & (best_i < bi))
            best_d = torch.where(keep, best_d, bd)
            best_i = torch.where(keep, best_i, bi)
    return best_i, best_d


def _assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("run,splits", [(1, 1), (8, 1), (8, 3), (8, 8),
                                        (3, 5), (32, 2)])
def test_run_min_scan_equals_nn_chunked(run, splits, exclude_self):
    """Integer clouds whose every point appears three times (ties at the
    minimum in and across runs and ranges), ragged run and range ends."""
    a = _cloud("int", 301, 1, dup=1)
    b = a if exclude_self else _cloud("int", 453, 2, dup=3)
    want = nn_chunked(a, b, exclude_self)
    _assert_same(run_min_nn(a, b, run, splits, exclude_self), want)
    if not exclude_self:  # ties at the minimum: the lowest index wins
        d = _offsets(a[None], b[None, None])[3][0]
        assert bool(((d == want[1][:, None]).sum(1) > 1).any())


@pytest.mark.parametrize("exclude_self", [False, True])
def test_run_min_scan_float_clouds(exclude_self):
    a = _cloud("float", 257, 3)
    b = a if exclude_self else _cloud("float", 640, 4)
    _assert_same(run_min_nn(a, b, 8, 3, exclude_self),
                 nn_chunked(a, b, exclude_self))


def test_all_inf_range_names_its_lowest_row():
    """A range whose every pair is at d = inf (the self pair of a one-row
    search) still names its lowest row, as nn_chunked does: each best
    starts at its range's first row, not at (inf, INT_MAX)."""
    a = torch.tensor([[1.0, 2.0, 3.0]])
    want = nn_chunked(a, a, exclude_self=True)
    assert int(want[0][0]) == 0 and bool(torch.isinf(want[1][0]))
    _assert_same(run_min_nn(a, a, 8, 1, exclude_self=True), want)


def test_split_count_properties():
    # the 60k pair on an H100 (132 SMs): 120 query blocks fill one wave
    assert nn.split_count(61440, 57344, 132, 8) == nn.MAX_SPLITS
    assert nn.split_count(61440, 57344, 132, 7) == 7
    assert nn.split_count(61440, 57344, 132, 2) == 2
    for na in (1, 100, 513, 4096, 61440, 10**6):
        for nb in (1, 2, 7, 1000, 61440):
            for per_sm in (1, 6, 8):
                s = nn.split_count(na, nb, 132, per_sm)
                assert 1 <= s <= min(nn.MAX_SPLITS, nb)
    assert nn.split_count(10**6, 10**6, 132, 8) == 1


def test_cpu_wrapper_runs_nn_chunked():
    """On CPU tensors the wrapper is nn_chunked, cross and self, and counts
    no launch."""
    a, b = _cloud("int", 300, 5), _cloud("int", 200, 6, dup=2)
    before = nn_argmin.launches
    _assert_same(nn_argmin(a, b), nn_chunked(a, b))
    _assert_same(nn_argmin(a, a, True), nn_chunked(a, a, True))
    assert nn_argmin.launches == before


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
def test_cuda_k5_at_aligned_and_ragged_counts(kind, cuda_device):
    """K5 on query counts that fill whole blocks of 128 threads x ROWS rows
    (512, 4096) and ragged ones (1, 127, 513, 5000), cross and self,
    bit-identical to nn_chunked on the card in index and distance."""
    b = _cloud(kind, 3000, 8, hi=40, dup=2).to(cuda_device)
    for na in (1, 127, 512, 513, 4096, 5000):
        a = _cloud(kind, na, 9 + na, hi=40).to(cuda_device)
        for q, s, ex in ((a, b, False), (b, a, False), (a, a, True)):
            before = nn_argmin.launches
            got = nn_argmin(q, s, ex)
            assert nn_argmin.launches == before + 1
            _assert_same(got, nn_chunked(q, s, ex))


@pytest.mark.cuda
def test_cuda_k5_at_the_small_path_shape(cuda_device):
    """The small-cloud path's largest shape, 61440 x 57344 padded rows, at
    the automatic split: equal to nn_chunked on a leading block of rows,
    and the one-row self search names row 0."""
    a = _cloud("int", 61440, 10, hi=400).to(cuda_device)
    b = _cloud("int", 57344, 11, hi=400, dup=2).to(cuda_device)
    got = nn_argmin(a, b)
    want = nn_chunked(a[:4096], b)
    _assert_same((got[0][:4096], got[1][:4096]), want)
    one = a[:1].contiguous()
    _assert_same(nn_argmin(one, one, exclude_self=True),
                 nn_chunked(one, one, exclude_self=True))
