"""PyTorch port: the kernel build cache key and the sources' bindings (no
nvcc needed).

A library is reused only while its ``<hash>`` directory matches: the hash
must cover the ``.cu`` source, every package header it includes (also
through other headers) and the flags, so an edited shared header never
loads a stale library. The ctypes bindings (``refine._ENTRIES``) must
match each C entry's parameters, and the 1-NN refines' shared walk must
keep its text, so the refines that do not take the asynchronous walk keep
their code.
"""
import glob
import hashlib
import re
import shutil

import pytest

from open_pcc_metric_tpu_torch.ops import _build
from open_pcc_metric_tpu_torch.ops.refine import _ENTRIES

KERNELS = ("refine_nn", "refine_knn", "knn_moments")


@pytest.fixture
def csrc(tmp_path):
    dest = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dest)
    return dest


def test_every_kernel_includes_the_shared_header():
    sources = sorted(glob.glob(f"{_build.CSRC_DIR}/*.cu"))
    # one for each Pallas kernel of the JAX package, K8 (knn_brute.cu),
    # whose JAX counterpart is plain XLA, and K9 (ply_decode.cu), whose
    # counterpart is the host's PLY parse
    assert len(sources) == 14
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


def _read(name):
    with open(f"{_build.CSRC_DIR}/{name}") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_entries_match_the_c_parameter_lists(name):
    """Each binding's pointer, int and float counts are its C entry's, in
    that order, with the stream last."""
    symbol, n_ptr, n_int, *n_float = _ENTRIES[name]
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)',
                       _read(f"{name}.cu"))[1]
    kinds = ["ptr" if "*" in p else p.split()[0] for p in params.split(",")]
    assert kinds == (["ptr"] * n_ptr + ["int"] * n_int
                     + ["float"] * sum(n_float) + ["ptr"])
    assert params.split(",")[-1].split() == ["void*", "stream"]


def test_one_nn_refines_include_both_headers():
    """The 1-NN refines take their step, skip, walk and merge from
    pcc_nn.cuh and include pcc_common.cuh too."""
    for name in ("refine_nn", "refine_nn_straight", "refine_nn_fused",
                 "refine_nn_payload", "adaptive_refine"):
        src = _read(f"{name}.cu")
        assert '#include "pcc_common.cuh"' in src, name
        assert '#include "pcc_nn.cuh"' in src, name


def _function(src, signature):
    """The text of the templated function whose declaration holds
    ``signature``, from its template line to its closing brace."""
    i = src.index(signature)
    start = src.rfind("\n", 0, src.rfind("template", 0, i)) + 1
    depth = 0
    for k in range(src.index("{", i), len(src)):
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            return src[start:k + 1]
    raise AssertionError(f"no body for {signature}")


def test_shared_walk_keeps_its_text():
    """nn::walk and the scan it runs are the text K1, K1b, K6 and K7 were
    compiled from; K1c's asynchronous walk sits beside them."""
    src = _read("pcc_nn.cuh")
    digests = {sig: hashlib.sha256(_function(src, sig).encode()).hexdigest()
               for sig in ("void walk(", "void scan_chunk(")}
    assert digests == {
        "void walk(": "d17b3a1bc9d2532c424380158abb0423"
                      "ed8bae9e0ecb4691fe3affc11020ce41",
        "void scan_chunk(": "7861dc5f81c0ef9f7c3255306b8403ee"
                            "fdbd509ceca329989aa0e877a7f78f82",
    }
    assert "constexpr int kStage = 8;" in src
    assert "void walk_async(" in src
