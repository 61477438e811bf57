"""The native cell-list k-NN (``native/src/neighbors.cc``) through ctypes.

The port's own loader of the host library the JAX package binds in
``nmrgnn_tpu/native.py``, for ``cell_list_knn`` only. It compiles
``native/src/neighbors.cc`` with the flags of ``native/Makefile``

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared

into ``build/nmrgnn_tpu_torch/libnmrgnn_knn-<hash>.so`` beside the package
(the hash covers the source and the flags), at the first call, and loads
it. When no compiler or source is there, or the build or the load fails,
``available()`` is False and ``data.neighbors.neighbors_host`` takes scipy,
as the JAX package does. Nothing under ``native/`` is written.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "src", "neighbors.cc")
BUILD_DIR = os.path.join(_ROOT, "build", "nmrgnn_tpu_torch")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnmrgnn_knn-{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                           text=True, timeout=_BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0 or not os.path.exists(tmp):
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(SOURCE):
            return None
        out = library_path()
        if not os.path.exists(out) and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        lib.cell_list_knn.restype = ctypes.c_int
        lib.cell_list_knn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def cell_list_knn(coords: np.ndarray, k: int):
    """(nlist i32[N, k], dists f32[N, k]) sorted by increasing distance,
    self excluded, or None when the library is not available."""
    lib = get_lib()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, np.float32)
    n = coords.shape[0]
    nlist = np.empty((n, k), np.int32)
    dists = np.empty((n, k), np.float32)
    r = lib.cell_list_knn(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, k,
        nlist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if r != 0:
        raise RuntimeError("native cell_list_knn failed")
    return nlist, dists
