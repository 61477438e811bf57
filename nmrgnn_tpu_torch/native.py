"""The native host runtime (``native/src/``) through ctypes: the cell-list
k-NN and the TFRecord scan and write.

The port's own loader of the host library the JAX package binds in
``nmrgnn_tpu/native.py``. It compiles ``native/src/tfrecord.cc`` and
``native/src/neighbors.cc`` with the flags of ``native/Makefile``

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared

into ``build/nmrgnn_tpu_torch/libnmrgnn_native-<hash>.so`` beside the
package (the hash covers the sources, ``crc32c.h`` and the flags), at the
first call, and loads it. When no compiler or source is there, or the
build or the load fails, ``available()`` is False and the callers take
their pure-Python paths (scipy's k-NN, the Python TFRecord framing), as
the JAX package does. Nothing under ``native/`` is written.
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
_SRC = os.path.join(_ROOT, "native", "src")
SOURCES = (os.path.join(_SRC, "tfrecord.cc"), os.path.join(_SRC, "neighbors.cc"))
HEADERS = (os.path.join(_SRC, "crc32c.h"),)
BUILD_DIR = os.path.join(_ROOT, "build", "nmrgnn_tpu_torch")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
_BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_P_LONG = ctypes.POINTER(ctypes.c_long)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in SOURCES + HEADERS:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnmrgnn_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES], capture_output=True,
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
        if not all(os.path.exists(p) for p in SOURCES + HEADERS):
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
        lib.tfrecord_scan.restype = ctypes.c_long
        lib.tfrecord_scan.argtypes = [ctypes.c_char_p, _P_LONG, _P_LONG, ctypes.c_long,
                                      ctypes.c_int]
        lib.tfrecord_write.restype = ctypes.c_int
        lib.tfrecord_write.argtypes = [ctypes.c_char_p, _P_U8, _P_LONG, ctypes.c_long,
                                       ctypes.c_int]
        lib.nmrgnn_masked_crc.restype = ctypes.c_uint32
        lib.nmrgnn_masked_crc.argtypes = [_P_U8, ctypes.c_long]
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


def masked_crc(data: bytes) -> Optional[int]:
    """TFRecord's masked crc32c of ``data`` (non-empty), or None when the
    library is not available."""
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8)
    if lib is None or not buf.size:
        return None
    return int(lib.nmrgnn_masked_crc(buf.ctypes.data_as(_P_U8), buf.size))


def tfrecord_scan(path: str, check_crc: bool = False, max_records: int = 1 << 22):
    """(offsets, lengths) int64 arrays of the record payloads of a TFRecord
    file, or None when the library is not available. Raises IOError on a
    CRC mismatch (``check_crc``) or a damaged file."""
    lib = get_lib()
    if lib is None:
        return None
    offsets = np.empty(max_records, np.int64)
    lengths = np.empty(max_records, np.int64)
    n = lib.tfrecord_scan(path.encode(), offsets.ctypes.data_as(_P_LONG),
                          lengths.ctypes.data_as(_P_LONG), max_records, 1 if check_crc else 0)
    if n == -2:
        raise IOError(f"CRC mismatch in {path}")
    if n < 0:
        raise IOError(f"native tfrecord_scan failed on {path} ({n})")
    return offsets[:n].copy(), lengths[:n].copy()


def tfrecord_write(path: str, payloads: list, append: bool = False) -> bool:
    """Frame and write ``payloads`` to ``path``; False when the library is
    not available (nothing written)."""
    lib = get_lib()
    if lib is None:
        return False
    blob = b"".join(payloads)
    buf = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    lengths = np.asarray([len(p) for p in payloads], np.int64)
    r = lib.tfrecord_write(path.encode(), buf.ctypes.data_as(_P_U8),
                           lengths.ctypes.data_as(_P_LONG), len(payloads), 1 if append else 0)
    if r != 0:
        raise IOError(f"native tfrecord_write failed on {path}")
    return True
