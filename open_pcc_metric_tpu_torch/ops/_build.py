"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Libraries land in ``build/torch_kernels/<hash>/`` beside
the package, where ``<hash>`` covers the source and the flags; a changed
source builds anew, an unchanged one is reused. Nothing is compiled when a
module is imported: the first CUDA launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import typing

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: typing.Dict[str, "BuiltLibrary"] = {}


class BuiltLibrary(typing.NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc/ptxas output of this build ("" when reused)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the package's kernels")


def _compile(src: str, dest: str) -> str:
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(dest))
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, dest)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def load(name: str) -> BuiltLibrary:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        dest = os.path.join(BUILD_ROOT, digest.hexdigest()[:16], f"lib{name}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(dest):
            t0 = time.perf_counter()
            log = _compile(src, dest)
            seconds = time.perf_counter() - t0
        built = BuiltLibrary(ctypes.CDLL(dest), dest, seconds, log)
        _LIBS[name] = built
        return built
