"""Build generated CUDA translation units with ``nvcc`` and load them.

Each kernel module writes one small ``.cu`` per traced energy: a header of
``csrc/`` plus generated code and ``extern "C"`` launchers.  This module
compiles it for sm_90a into ``mfem_ad_tpu_torch/_build/`` under a name that
hashes the source, the headers it includes and the compiler flags (so a
changed energy, header or flag builds a new library), replaces the file
atomically, and binds the launchers through ``ctypes``.  Nothing is built
or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@functools.lru_cache(maxsize=None)
def _header(name: str) -> bytes:
    with open(os.path.join(CSRC, name), "rb") as fh:
        return fh.read()


def library_path(stem: str, source: str, headers: tuple) -> str:
    """Where the library built from ``source`` lives: ``lib<stem>_<hash>.so``
    with the hash of the source, the ``csrc/`` headers it includes and the
    compiler flags."""
    h = hashlib.sha256()
    h.update(source.encode())
    for name in headers:
        h.update(_header(name))
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:20]}.so")


def build_library(stem: str, source: str, headers: tuple) -> str:
    """Compile ``source`` when its library is missing; returns the
    compiler's report (empty when the library already exists).  Raises
    when nvcc is missing or fails."""
    lib = library_path(stem, source, headers)
    if os.path.exists(lib):
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {stem} cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem_path = f"{lib[:-3]}.{os.getpid()}"
    src = f"{stem_path}.cu"
    with open(src, "w") as fh:
        fh.write(source)
    tmp = f"{stem_path}.tmp"
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        for leftover in (src, tmp):
            if os.path.exists(leftover):
                os.remove(leftover)
    return proc.stdout + proc.stderr


_LIBRARIES: dict[str, ctypes.CDLL] = {}  # kernel source -> its library


def load_library(stem: str, source: str, headers: tuple,
                 launchers: dict) -> ctypes.CDLL:
    """The library of ``source``, built at its first use and then cached in
    the process (no file is touched on later calls).  ``launchers`` maps
    each exported function to its ``argtypes``; each returns an int."""
    lib = _LIBRARIES.get(source)
    if lib is None:
        build_library(stem, source, headers)
        lib = ctypes.CDLL(library_path(stem, source, headers))
        for name, argtypes in launchers.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _LIBRARIES[source] = lib
    return lib
