"""The pieces of PaiNN, the polarizable atom interaction network (Schütt,
Unke and Gastegger, ICML 2021, arXiv:2102.03150; schnetpack
``representation/painn.py``: ``PaiNN``, ``PaiNNInteraction``,
``PaiNNMixing``), in plain PyTorch over the port's padded neighbor lists.

Each atom carries a scalar state s [N, F] and a vector state v [N, 3, F];
a slot (i, j) of the neighbor list carries r_ij = x_j - x_i, d = |r_ij|
and r^ = r_ij / d.

    filter   W = Dense(phi(d)) * f_cut(d)        [N, K, B * 3F], 3F a block
             phi_n = sin(n pi d_A / r_c) / d_A   n = 1..R, d_A in Angstrom
             f_cut = (cos(pi d / r_c) + 1) / 2   for d < r_c, else 0
    message  (a, b, c) = split(W_ij * Dense(F, 3F)(act(Dense(F, F)(s)))_j)
             s_i += sum_j a;   v_i += sum_j (b r^_ij + c v_j)
    update   (V, U) = split(v @ W_mix)           W_mix [F, 2F], no bias
             (a, b, c) = split(Dense(F, 3F)(act(Dense(2F, F)([s, |V|]))))
             v += b U;   s += a + c sum_xyz(V U)  |V| = sqrt(sum_xyz V^2 + 1e-8)

The sums run over an atom's slots (not nmrgnn's inv_degree mean). A slot
with distance 0 in the graph's ``edges`` is padding: its distance is taken
as r_c, where f_cut is exactly 0, so its filter, and with it everything
it adds, is exactly 0, with no 0 * inf on the way. The Dense layers are
the caller's ``dense`` (``models.gnn.dense``'s signature: operands in
``compute_dtype``, float32 sums); the rest is float32.

No TPU kernel: the JAX package has no such family. On the card the
message's sums are one hand-written kernel a block (``message``,
``csrc/painn.cu``); the rest is plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda
from .banded import _check, _on_cuda
from .edge import as_operand

ANGSTROM_PER_NM = 10.0
NORM_EPS = 1e-8  # schnetpack's PaiNNMixing epsilon
MAX_F = 256      # atom features the message kernel takes (8 channels a lane)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "nmr_error_string": (ctypes.c_char_p, [_I]),
    "nmr_painn_message": (_I, [_P] * 9 + [_I] * 3 + [_L, _L, _P]),
}


def edge_geometry(positions: torch.Tensor, nlist: torch.Tensor, edges: torch.Tensor,
                  cutoff: float):
    """(d f32[N, K] nm, r^ f32[N, K, 3]) of each slot from ``positions``
    f32[N, 3] nm; a padding slot (``edges`` <= 0) gets d = ``cutoff`` and
    r_ij / ``cutoff``, both finite."""
    r = positions[nlist.long()] - positions[:, None, :]
    d = torch.where(edges > 0, torch.sqrt((r * r).sum(-1)), torch.full_like(edges, cutoff))
    return d, r / d[..., None]


def bessel_basis(d: torch.Tensor, count: int, cutoff: float) -> torch.Tensor:
    """f32[..., count]: sin(n pi d / cutoff) / d for n = 1..count, the
    distance divided by in Angstrom as published (``d`` and ``cutoff`` in
    nm)."""
    n = torch.arange(1, count + 1, device=d.device, dtype=torch.float32)
    return torch.sin(d[..., None] * (n * (math.pi / cutoff))) / (ANGSTROM_PER_NM * d[..., None])


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """(cos(pi d / cutoff) + 1) / 2 below ``cutoff``, else exactly 0."""
    f = 0.5 * (torch.cos(d * (math.pi / cutoff)) + 1.0)
    return torch.where(d < cutoff, f, torch.zeros_like(f))


def filters(p: dict, d: torch.Tensor, count: int, cutoff: float,
            compute_dtype=torch.float32) -> torch.Tensor:
    """W f32[N, K, D] = (phi(d) @ kernel + bias) * f_cut(d) for the filter
    Dense ``p`` {kernel [count, D], bias [D]}, as one product: the cutoff
    scales the basis and rides, with the bias, in one more input column,
    so that the [N, K, D] output is written once (in a lower
    ``compute_dtype`` the bias is rounded with the other operands)."""
    fc = cosine_cutoff(d, cutoff)[..., None]
    basis = torch.cat([bessel_basis(d, count, cutoff) * fc, fc], -1)
    kernel = torch.cat([p["kernel"], p["bias"][None]], 0)
    return as_operand(basis, compute_dtype) @ as_operand(kernel, compute_dtype)


def context(p: dict, s: torch.Tensor, activation, dense,
            compute_dtype=torch.float32) -> torch.Tensor:
    """ctx [N, 3F] = Dense(F, 3F)(act(Dense(F, F)(s))): ``p["context"]``."""
    return dense(p["context"][1], dense(p["context"][0], s, activation, compute_dtype),
                 None, compute_dtype)


def message_sums_plain(s: torch.Tensor, v: torch.Tensor, ctx: torch.Tensor, w: torch.Tensor,
                       unit: torch.Tensor, nlist: torch.Tensor):
    """(s + sum_j a, v + sum_j (b r^ + c v_j)), (a, b, c) = split(W_ij * ctx_j),
    over every slot of ``nlist`` (a padding slot's filter is exactly 0): the
    plain version of ``message``'s kernel."""
    F = s.shape[-1]
    nl = nlist.long()
    x = ctx[nl].mul_(w)                                   # [N, K, 3F]
    a, b, c = x.split(F, -1)
    vj = v[nl].mul_(c[:, :, None, :])                     # [N, K, 3, F]
    dv = torch.einsum("nkx,nkf->nxf", unit, b) + vj.sum(1)
    return s + a.sum(1), v + dv


def kernel_args(s: torch.Tensor, v: torch.Tensor, ctx: torch.Tensor, w: torch.Tensor,
                unit: torch.Tensor, nlist: torch.Tensor, edges: torch.Tensor):
    """(N, K, F, W's atom stride, W's slot stride) of a call of ``message``'s
    kernel; raises on what the kernel does not take. Every tensor on
    ``s``'s device; float32 s [N, F], v [N, 3, F], ctx [N, 3F], unit
    [N, K, 3], edges [N, K] and int32 nlist [N, K], contiguous and 16-byte
    aligned; F a multiple of 32 up to ``MAX_F``; w float32 [N, K, 3F] with
    the last stride 1 and the others multiples of 4 (a column slice of the
    filter [N, K, 3BF], taken in place)."""
    n, F = s.shape if s.dim() == 2 else (None, None)
    if F is None or F % 32 or not 32 <= F <= MAX_F:
        raise ValueError(f"painn.message kernel: s has shape {tuple(s.shape)}; it takes "
                         f"[N, F], F a multiple of 32 up to {MAX_F}")
    K = nlist.shape[-1] if nlist.dim() == 2 else -1
    dev = s.device
    for name, t, dtype, shape in (("s", s, torch.float32, (n, F)),
                                  ("v", v, torch.float32, (n, 3, F)),
                                  ("ctx", ctx, torch.float32, (n, 3 * F)),
                                  ("unit", unit, torch.float32, (n, K, 3)),
                                  ("nlist", nlist, torch.int32, (n, K)),
                                  ("edges", edges, torch.float32, (n, K))):
        _check(name, t, dtype, shape, dev)
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, expected {dev}")
    if w.dtype != torch.float32:
        raise TypeError(f"w has dtype {w.dtype}, expected torch.float32")
    if tuple(w.shape) != (n, K, 3 * F):
        raise ValueError(f"w has shape {tuple(w.shape)}, expected {(n, K, 3 * F)}")
    if w.stride(2) != 1 or w.stride(0) % 4 or w.stride(1) % 4 or w.data_ptr() % 16:
        raise ValueError(f"w has strides {w.stride()}: the kernel takes the last stride 1, "
                         f"the others multiples of 4, 16-byte aligned")
    return n, K, F, w.stride(0), w.stride(1)


def message(p: dict, s: torch.Tensor, v: torch.Tensor, w: torch.Tensor, unit: torch.Tensor,
            nlist: torch.Tensor, edges: torch.Tensor, activation, dense,
            compute_dtype=torch.float32):
    """(s, v) after PaiNNInteraction: ``p`` {"context": [Dense(F, F),
    Dense(F, 3F)]}, ``w`` f32[N, K, 3F] this block's filter, ``unit`` the
    slots' r^ f32[N, K, 3], ``edges`` the graph's distances (0 on padding).

    No TPU kernel: the JAX package has no PaiNN. On the card the context
    Dense layers run as they are and one launch of ``csrc/painn.cu``
    computes the sums over the real slots (``edges`` > 0) in registers,
    reading ``w`` in place by its strides (``kernel_args``); it counts its
    launches in ``.launches``. On the CPU: ``message_sums_plain``."""
    ctx = context(p, s, activation, dense, compute_dtype)
    if not _on_cuda(s, "painn.message"):
        return message_sums_plain(s, v, ctx, w, unit, nlist)
    n, K, F, w_atom, w_slot = kernel_args(s, v, ctx, w, unit, nlist, edges)
    s_out, v_out = torch.empty_like(s), torch.empty_like(v)
    _cuda.launch("painn", _SIGNATURES, "nmr_painn_message", s.device, s.data_ptr(),
                 v.data_ptr(), ctx.data_ptr(), w.data_ptr(), unit.data_ptr(), nlist.data_ptr(),
                 edges.data_ptr(), s_out.data_ptr(), v_out.data_ptr(), n, K, F, w_atom, w_slot)
    message.launches += 1
    return s_out, v_out


message.launches = 0


def update(p: dict, s: torch.Tensor, v: torch.Tensor, activation, dense,
           compute_dtype=torch.float32):
    """(s, v) after PaiNNMixing: ``p`` {"mix": [Dense(2F, F), Dense(F, 3F)],
    "channel_mix": {kernel [F, 2F]}}."""
    F = s.shape[-1]
    vu = dense(p["channel_mix"], v, None, compute_dtype)   # [N, 3, 2F]
    V, U = vu[..., :F], vu[..., F:]
    norm = torch.sqrt((V * V).sum(1) + NORM_EPS)
    x = dense(p["mix"][1], dense(p["mix"][0], torch.cat([s, norm], -1), activation,
                                 compute_dtype), None, compute_dtype)
    a, b, c = x.split(F, -1)
    return s + a + c * (V * U).sum(1), v + b[:, None, :] * U
