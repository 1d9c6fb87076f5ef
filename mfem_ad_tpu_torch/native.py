"""ctypes bindings to the native host-side meshkit (native/meshkit.cc).

The FE-space graph builder — unique edge/face enumeration for dof
numbering — is host-side setup work the reference delegates to MFEM's C++
``FiniteElementSpace``.  Here it lives in a small C++ library built on
first use (g++ -O3 -shared); every entry point has a pure-numpy fallback
so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_DIR, "libmeshkit.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src = os.path.join(_DIR, "meshkit.cc")
    stale = os.path.exists(_LIB_PATH) and os.path.exists(src) and (
        os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    )
    if (not os.path.exists(_LIB_PATH) or stale) and os.path.exists(src):
        try:
            subprocess.run(
                ["make", "-C", _DIR], check=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.mk_unique_rows.restype = ctypes.c_int64
    lib.mk_unique_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mk_edge_dofs.restype = None
    lib.mk_edge_dofs.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def unique_rows(rows: np.ndarray):
    """Unique rows + inverse of an [n, k] integer array.

    Equivalent to ``np.unique(rows, axis=0, return_inverse=True)`` but
    ~10x faster via the native sort (falls back to numpy when the native
    library is unavailable).
    """
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n, k = rows.shape
    lib = _load()
    if lib is None or n == 0:
        return np.unique(rows, axis=0, return_inverse=True)
    inverse = np.empty(n, dtype=np.int64)
    uniq = np.empty((n, k), dtype=np.int64)
    nu = lib.mk_unique_rows(_ptr(rows), n, k, _ptr(inverse), _ptr(uniq))
    return uniq[:nu].copy(), inverse


def edge_dofs(a, b, edge_id, off_edge: int, npe: int, p: int, kk: int):
    """Orientation-canonical edge dof ids (fespace.py H1 edge class)."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    edge_id = np.ascontiguousarray(edge_id, dtype=np.int64)
    lib = _load()
    if lib is None:
        c = np.where(a < b, kk, p - kk)
        return off_edge + edge_id * npe + (c - 1)
    out = np.empty(a.shape[0], dtype=np.int64)
    lib.mk_edge_dofs(
        _ptr(a), _ptr(b), _ptr(edge_id), a.shape[0],
        off_edge, npe, p, kk, _ptr(out),
    )
    return out
