"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Libraries land in ``build/torch_kernels/<hash>/`` beside
the package, where ``<hash>`` covers the source, the package headers it
includes (``csrc/*.cuh``) and the flags; a changed source or header builds
anew, an unchanged one is reused. Nothing is compiled when a module is
imported: the first CUDA launch builds, or ``load_many`` builds several
sources at once, one ``nvcc`` each, all started together.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
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

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_LOCK = threading.Lock()
_LIBS: typing.Dict[str, "BuiltLibrary"] = {}


class BuiltLibrary(typing.NamedTuple):
    lib: ctypes.CDLL
    path: str
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


def source_digest(name: str, csrc_dir: str = CSRC_DIR) -> str:
    """Hash of ``<csrc_dir>/<name>.cu``, of every header it includes from
    ``csrc_dir`` (followed through the headers' own includes) and of the
    flags, so an edited shared header never reuses a stale library."""
    digest = hashlib.sha256()
    seen: typing.List[str] = []
    todo = [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        path = os.path.join(csrc_dir, rel)
        if rel in seen or (seen and not os.path.exists(path)):
            continue  # toolkit headers are not the package's to hash
        seen.append(rel)
        with open(path, "rb") as f:
            text = f.read()
        digest.update(rel.encode() + b"\0" + text + b"\0")
        todo += [m.decode() for m in _INCLUDE.findall(text)]
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


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


def _build_one(name: str) -> BuiltLibrary:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    dest = os.path.join(BUILD_ROOT, source_digest(name), f"lib{name}.so")
    log = _compile(src, dest) if not os.path.exists(dest) else ""
    return BuiltLibrary(ctypes.CDLL(dest), dest, log)


def load_many(names: typing.Sequence[str]) -> typing.Dict[str, BuiltLibrary]:
    """Build (once per source hash) and load ``csrc/<name>.cu`` for every
    name, the missing ones in parallel."""
    with _LOCK:
        todo = [n for n in dict.fromkeys(names) if n not in _LIBS]
        if todo:
            with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
                _LIBS.update(zip(todo, pool.map(_build_one, todo)))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> BuiltLibrary:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    return load_many([name])[name]
