"""PyTorch port: the kernel build cache key (no nvcc needed).

A library is reused only while its ``<hash>`` directory matches: the hash
must cover the ``.cu`` source, every package header it includes (also
through other headers) and the flags, so an edited shared header never
loads a stale library.
"""
import glob
import shutil

import pytest

from open_pcc_metric_tpu_torch.ops import _build

KERNELS = ("refine_nn", "refine_knn", "knn_moments")


@pytest.fixture
def csrc(tmp_path):
    dest = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dest)
    return dest


def test_every_kernel_includes_the_shared_header():
    sources = sorted(glob.glob(f"{_build.CSRC_DIR}/*.cu"))
    assert len(sources) == 12  # one for each Pallas kernel of the JAX package
    for path in sources:
        with open(path) as f:
            assert '#include "pcc_common.cuh"' in f.read(), path


def test_digest_follows_sources_and_headers(csrc):
    def digests():
        return {n: _build.source_digest(n, str(csrc)) for n in KERNELS}

    before = digests()
    assert before == {n: _build.source_digest(n) for n in KERNELS}
    assert len(set(before.values())) == len(KERNELS)
    # a header edit rebuilds every kernel that includes it
    header = csrc / "pcc_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = digests()
    assert all(after[n] != before[n] for n in KERNELS)
    # a nested header is followed too
    (csrc / "extra.cuh").write_text("#pragma once\n")
    header.write_text('#include "extra.cuh"\n' + header.read_text())
    nested = digests()
    (csrc / "extra.cuh").write_text("#pragma once\n// edited\n")
    mid = digests()
    assert all(mid[n] != nested[n] for n in KERNELS)
    # a source edit rebuilds that kernel only
    src = csrc / "refine_knn.cu"
    src.write_text(src.read_text() + "\n")
    last = digests()
    assert [last[n] != mid[n] for n in KERNELS] == [False, True, False]
