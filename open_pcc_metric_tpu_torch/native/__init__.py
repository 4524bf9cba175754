"""ctypes loader (with on-demand g++ build) for the native host hot loops.

Every entry point degrades gracefully: when no compiler or prebuilt library
is available, callers use their numpy fallbacks. The library is compiled once
into this package directory (atomic rename, safe under concurrent import).
"""
from __future__ import annotations

import ctypes
import locale
import os
import subprocess
import tempfile
import typing

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "pccio.cpp")
_SO = os.path.join(_DIR, "libpccio.so")

_lib: typing.Any = None  # None = untried, False = unavailable


def _build() -> bool:
    try:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
        os.close(fd)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib():
    """The loaded CDLL, or None when native support is unavailable."""
    global _lib
    if _lib is not None:
        return _lib or None
    needs_build = (not os.path.exists(_SO)) or (
        os.path.getmtime(_SO) < os.path.getmtime(_SRC)
    )
    if needs_build and not _build():
        _lib = False
        return None
    try:
        locale.setlocale(locale.LC_NUMERIC, "C")  # strtod decimal point
        lib = ctypes.CDLL(_SO)
        lib.pcc_parse_floats.restype = ctypes.c_long
        lib.pcc_parse_floats.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ]
        lib.pcc_radix_argsort_u32.restype = ctypes.c_int
        lib.pcc_radix_argsort_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pcc_gather_rows_f64.restype = None
        lib.pcc_gather_rows_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    except Exception:
        _lib = False
        return None
    return _lib


def parse_floats(data: bytes, count: int) -> typing.Optional[np.ndarray]:
    """Parse `count` whitespace-separated numbers from bytes; None on miss."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(count, dtype=np.float64)
    got = lib.pcc_parse_floats(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), count,
    )
    if got != count:
        return None
    return out


def radix_argsort_u32(keys: np.ndarray) -> typing.Optional[np.ndarray]:
    """Stable argsort of uint32 keys; None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    perm = np.empty(keys.shape[0], dtype=np.int32)
    rc = lib.pcc_radix_argsort_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        keys.shape[0],
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:  # scratch allocation failed: perm is uninitialised
        return None
    return perm


def gather_rows(src: np.ndarray, perm: np.ndarray) -> typing.Optional[np.ndarray]:
    """out[i] = src[perm[i]] for float64 (n, cols); None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.float64)
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    out = np.empty((perm.shape[0], src.shape[1]), dtype=np.float64)
    lib.pcc_gather_rows_f64(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        perm.shape[0], src.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
