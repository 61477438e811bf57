"""The port's kernel-launch layer: build its CUDA sources with ``nvcc``,
bind them with ``ctypes``, and wrap each kernel for PyTorch.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (the ``*.cuh`` headers are included by the sources; ``hbm.cu``,
``fused_first.cu`` and ``blocksparse.cu`` share ``mp.cuh``'s MP kernel),
compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``build/nmrgnn_tpu_torch/`` beside the package, under a name keyed
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The build runs at the first launch on a
CUDA tensor, never at import; a failed build raises. ``build()`` compiles
several sources at once, one ``nvcc`` process each.

Every entry point's argument types are in one table (``_ENTRY_POINTS``),
so a launch names only its entry point (``launch``). Every op module's
kernel wrapper is made by ``kernel``: the plain PyTorch version for a CPU
tensor, the launch on the card, counted in ``.launches`` and enrolled in
``KERNEL_WRAPPERS``. The argument helpers below (``check``, ``at``,
``col``, ...) are what the wrappers share before a launch.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import inspect
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "nmrgnn_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_NVCC_TIMEOUT_S = 900

_P, _I, _L, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FUSED = [_P] * 8 + [_I] * 7 + [_F32] * 3 + [_I] * 5 + [_P]
_MP = [_P] * 8 + [_I] * 9 + [_P, _P]
_MP_PARTIAL = [_P] * 6 + [_I] * 8 + [_P, _P]
_MP_FUSED_FIRST = [_P] * 9 + [_I] * 8 + [_F32] * 3 + [_I] * 3 + [_P, _P]
_MP_PAIRS = [_P] * 8 + [_I] * 8 + [_P, _P]
_OCC_FROM_BAND = [_P, _P] + [_I] * 4 + [_P]
# The argument types of every entry point, by source. Each entry point
# takes the stream last and returns an error code (0 for none), which the
# source's ``nmr_error_string`` names.
_ENTRY_POINTS = {
    "banded": {
        "nmr_build_band": [_P] * 4 + [_I] * 9 + [_P],
        "nmr_permute_tile_bounds": [_P] * 11 + [_I] * 4 + [_P],
        "nmr_build_band_fused": _FUSED,
    },
    "fused_wide": {"nmr_build_band_fused_wide": _FUSED},
    "poly": {"nmr_build_band_poly": [_P] * 6 + [_I] * 8 + [_F32] * 3 + [_I] * 2 + [_P]},
    "hbm": {
        "nmr_mp_banded": _MP,
        "nmr_mp_banded_bf16": _MP,
        "nmr_mp_banded_partial": _MP_PARTIAL,
        "nmr_mp_banded_partial_bf16": _MP_PARTIAL,
        "nmr_band_occupancy": [_P] * 5 + [_I] * 6 + [_P],
        "nmr_band_occupancy_from_band": _OCC_FROM_BAND,
        "nmr_band_occupancy_from_band_bf16": _OCC_FROM_BAND,
    },
    "fused_first": {
        "nmr_mp_banded_poly_fused": _MP_FUSED_FIRST,
        "nmr_mp_banded_poly_fused_bf16": _MP_FUSED_FIRST,
    },
    "blocksparse": {
        "nmr_build_block_adjacency": [_P] * 6 + [_I] * 8 + [_P],
        "nmr_mp_blocksparse": _MP_PAIRS,
        "nmr_mp_blocksparse_bf16": _MP_PAIRS,
        "nmr_block_occupancy": [_P] * 6 + [_I] * 5 + [_P],
        "nmr_block_occupancy_from_adjacency": [_P, _P] + [_I] * 4 + [_P],
    },
    "painn": {"nmr_painn_message": [_P] * 9 + [_I] * 3 + [_L, _L, _P]},
    "attention": {"nmr_amp_layer": [_P] * 8 + [_I] * 5 + [_P]},
    "et": {"nmr_et_attention": [_P] * 14 + [_I] * 7 + [_P]},
}
SOURCES = tuple(_ENTRY_POINTS)
_SOURCE = {fn: name for name, fns in _ENTRY_POINTS.items() for fn in fns}

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


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    every entry point's ``restype`` and ``argtypes`` set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.nmr_error_string.restype = ctypes.c_char_p
            lib.nmr_error_string.argtypes = [_I]
            for fn, argtypes in _ENTRY_POINTS[name].items():
                f = getattr(lib, fn)
                f.restype = _I
                f.argtypes = argtypes
            _libs[name] = lib
    return lib


def launch(fn: str, device, *args) -> None:
    """Call entry point ``fn`` with ``args`` and the current stream of
    ``device``; raise on a non-zero return code."""
    lib = library(_SOURCE[fn])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} ({lib.nmr_error_string(rc).decode()})")


# -- Dispatch and the registry -------------------------------------------------

KERNEL_WRAPPERS: tuple = ()  # the forwards' kernel wrappers, in the order defined
_WRAPPERS: list = []         # every kernel wrapper, the request preparation's too


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {x.device} are not supported")
    return True


def kernel(plain, on: str, *, forward: bool = True, route=None):
    """Decorator of a kernel wrapper's card path ``body``, whose argument
    ``on`` is the tensor that picks the device. The wrapper calls
    ``plain`` with the same arguments for a CPU tensor (looked up by name
    in ``body``'s module at each call, so that a test may replace it),
    raises for a device that is neither CPU nor CUDA, and on the card runs
    ``body`` and then adds one to its ``.launches``: one count a call,
    however many kernels the call launches. ``route``, given, is asked
    first on the card: a function of the call that returns another
    wrapper to take (and count) it, or None. The wrapper is enrolled in
    ``KERNEL_WRAPPERS`` (with ``forward`` False only in
    ``reset_launch_counts``: the request preparation counts its launches
    apart from the forwards')."""

    def wrap(body):
        global KERNEL_WRAPPERS
        name, module = body.__name__, body.__globals__
        pos = list(inspect.signature(body).parameters).index(on)

        @functools.wraps(body)
        def wrapper(*args, **kwargs):
            x = args[pos] if len(args) > pos else kwargs[on]
            if not on_cuda(x, name):
                return module[plain.__name__](*args, **kwargs)
            other = None if route is None else route(*args, **kwargs)
            if other is not None:
                return other(*args, **kwargs)
            out = body(*args, **kwargs)
            wrapper.launches += 1
            return out

        wrapper.launches = 0
        _WRAPPERS.append(wrapper)
        if forward:
            KERNEL_WRAPPERS += (wrapper,)
        return wrapper

    return wrap


def reset_launch_counts() -> None:
    """Zero the launch counts of every kernel wrapper: the forwards'
    (``KERNEL_WRAPPERS``) and the request preparation's
    (``permute_tile_bounds``)."""
    for f in _WRAPPERS:
        f.launches = 0


# -- Argument helpers ------------------------------------------------------------

# Element types the kernels take, and the suffix of their entry points.
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is on ``device``, of ``dtype`` and ``shape``,
    contiguous and 16-byte aligned, as the kernels read it."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def dtype_suffix(name: str, dtype) -> str:
    """The entry-point suffix of a kernel on ``dtype``: "" for float32,
    "_bf16" for bfloat16; raises for another."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name} has dtype {dtype}; the kernels take float32 or bfloat16")
    return _SUFFIX[dtype]


def bf16_flag(name: str, dtype) -> int:
    """The kernels' type flag: 0 for float32, 1 for bfloat16."""
    return int(dtype_suffix(name, dtype) != "")


def as_long(a, device) -> torch.Tensor:
    """``a`` (a tensor or numpy) as int64 on ``device``."""
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=torch.int64)


def device_index(name: str, a, length: int, device) -> torch.Tensor:
    """An int32 index array (tile ids, window starts) on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(a, np.int32))
    t = t.to(device=device, dtype=torch.int32).contiguous()
    check(name, t, torch.int32, (length,), device)
    return t


def at(t: torch.Tensor, axis: int, c0: int) -> int:
    """The address of index ``c0`` along ``axis`` of ``t`` (a channel
    group's first channel)."""
    return t.data_ptr() + c0 * t.stride(axis) * t.element_size()


def col(t: torch.Tensor, c0: int) -> int:
    """The address of column ``c0`` of the first row of a 2-D tensor."""
    return t.data_ptr() + c0 * t.element_size()
