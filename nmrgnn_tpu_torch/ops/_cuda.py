"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (the ``*.cuh`` headers are included by the sources; ``hbm.cu``
and ``fused_first.cu`` share ``mp.cuh``'s MP kernel), compiled
for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``build/nmrgnn_tpu_torch/`` beside the package, under a name keyed
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The build runs at the first launch on a
CUDA tensor, never at import; a failed build raises. ``build()`` compiles
several sources at once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "nmrgnn_tpu_torch")
SOURCES = ("banded", "fused_wide", "poly", "hbm", "fused_first", "blocksparse", "painn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_NVCC_TIMEOUT_S = 900

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin)")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, str]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together. Returns the compiler output by name
    (with ``verbose``, ptxas's register and shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out) and not verbose:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    logs, errors = {}, []
    for name, out, tmp, cmd, proc in jobs:
        try:
            log, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            errors.append(f"{name}: nvcc timed out after {_NVCC_TIMEOUT_S} s\n{log}")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}: {' '.join(cmd)} exited {proc.returncode}\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
        logs[name] = log
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


def library(name: str, signatures: Dict[str, Tuple[object, list]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``restype`` and ``argtypes`` set from ``signatures``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
    return lib


def launch(name: str, signatures: Dict[str, Tuple[object, list]], fn: str, device,
           *args) -> None:
    """Call entry point ``fn`` of ``csrc/<name>.cu`` with ``args`` and the
    current stream of ``device``; raise on a non-zero return code."""
    import torch

    lib = library(name, signatures)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} ({lib.nmr_error_string(rc).decode()})")
