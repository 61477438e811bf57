"""The pieces of TorchMD-Net's equivariant transformer (ET; Thölke and De
Fabritiis, ICLR 2022, arXiv:2202.02541; torchmd-net ``models/torchmd_et.py``:
``TorchMD_ET``, ``EquivariantMultiHeadAttention``; ``models/utils.py``:
``ExpNormalSmearing``, ``CosineCutoff``, ``NeighborEmbedding``), in plain
PyTorch over the port's padded neighbor lists.

Each atom carries a scalar state x [N, F] and a vector state v [N, 3, F];
F = H heads of D = F / H. A slot (i, j) carries r^ = (x_j - x_i) / d, its
cosine cutoff C(d) and its radial basis f [R], distances in Angstrom as
published (d_A = 10 d_nm):

    basis      f = C(d) exp(-beta (exp(-alpha (d_A - low_A)) - mu_n)^2)
               alpha = 5 / (high_A - low_A), mu_n = linspace(exp(low_A - high_A), 1, R),
               beta = (2 / R (1 - exp(low_A - high_A)))^-2
    embedding  x = Dense(2F, F)([x, sum_j (Dense(R, F)(f_ij) C(d_ij)) E_nb(z_j)])
    a layer    y = LayerNorm(x);  q, k = Dense(F, F)(y);  v = Dense(F, 3F)(y)
               (u1, u2, u3) = split(v_state @ W_vec);  vec_dot = sum_xyz u1 u2
               over the real slots of i and its self term (d = 0, C = 1, r^ = 0):
                 dk = act(Dense(R, F)(f)), dv = act(Dense(R, 3F)(f))
                 a = act(sum_d q_i k_j dk) C(d)               a head each
                 (s, m1, m2) = split(v_j dv)                  [H, 3D] a head, D each
                 Sx_i = sum_j a s,  Sv_i = sum_j (v_state_j m1 + m2 r^_ij)
               (o1, o2, o3) = split(Dense(F, 3F)(Sx))
               x += vec_dot o2 + o3;  v_state += u3 o1 + Sv
    last       x = LayerNorm(x)

A slot is an edge of the cutoff graph when the graph's ``edges`` is above
0 (0 marks padding) and its distance from the positions lies below the
cutoff, as torchmd-net's radius graph holds no other. The value message
carries no cutoff factor and dv = act(bias) is not 0 where f is, so a
slot outside the graph is masked: its neighbor index is redirected to a
row of zeros appended to k, v and v_state (row N), which makes its
logit, values and vector message, and so everything it adds, exactly 0.
Its distance is taken as the cutoff (``painn.edge_geometry``), where C
and f are exactly 0, with no 0 * inf on the way. The self term is added
here, once an atom, never read from the graph.

The basis carries a column of ones after its R functions (and zero
columns to a multiple of 8), so that each filter product takes its bias
as one more kernel row and writes its [rows, K + 1, F] or [rows, K + 1,
3F] once. dv's columns (and v's) are ordered (part, head, dim), not
torchmd-net's (head, part, dim), so that s, m1 and m2 are each a
contiguous [F] (a permutation of columns, exact). The attention stage
runs over blocks of ``BLOCK_ROWS`` rows of the neighbor list, so that its
per-slot temporaries (the filters and the gathered rows, about 14 KB a
slot at F = 256) stay near 2.5 GB at K = 80. The Dense layers are the
caller's ``dense`` (``models.gnn.dense``'s signature: operands in
``compute_dtype``, float32 sums), the filter products ``as_operand`` the
same; the rest is float32. No TPU kernel: the JAX package has no such
family.

On the card the attention stage is one hand-written kernel a layer
(``fused_attention``, ``csrc/et.cu``): the filters, the head logits and
both sums in registers over the real slots only (no zero row, no [rows,
K + 1, 4F] tensor), writing only Sx and Sv. ``attention`` is its plain
version, which the CPU and a call while autograd records take.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ._cuda import check, kernel, launch
from .edge import as_operand
from .painn import ANGSTROM_PER_NM, cosine_cutoff, edge_geometry

LN_EPS = 1e-5       # torch.nn.LayerNorm's epsilon, torchmd-net's
BLOCK_ROWS = 2048   # neighbor-list rows an attention block takes (module docstring)
HEAD_WIDTHS = (16, 32, 64)  # head widths D = F / H the kernel is built for
MAX_FUNCTIONS = 128         # radial functions R the kernel takes
MAX_SLOTS = 129             # slots a row the kernel takes: K up to 128, then the self term


class Geometry(NamedTuple):
    """A forward's slots, each row's K graph slots then its self term
    (K + 1 columns), computed once a forward and read by every layer:
    ``nlist`` int64 [N, K + 1] (N for a slot that is no edge), ``basis``
    [N, K + 1, R'] (f, a column of ones, zero columns to R' a multiple of
    8), ``cut`` C [N, K + 1], ``unit`` r^ [N, K + 1, 3]."""

    nlist: torch.Tensor
    basis: torch.Tensor
    cut: torch.Tensor
    unit: torch.Tensor


def expnorm_basis(d: torch.Tensor, count: int, low: float, high: float) -> torch.Tensor:
    """f32[..., count]: ExpNormalSmearing of ``d`` (nm) with its cosine
    cutoff, between ``low`` and ``high`` (nm), in Angstrom as published."""
    low_a, high_a = ANGSTROM_PER_NM * low, ANGSTROM_PER_NM * high
    start = math.exp(low_a - high_a)
    mu = torch.linspace(start, 1.0, count, device=d.device, dtype=torch.float32)
    beta = (2.0 / count * (1.0 - start)) ** -2
    alpha = 5.0 / (high_a - low_a)
    e = torch.exp(alpha * (low_a - ANGSTROM_PER_NM * d))[..., None] - mu
    return cosine_cutoff(d, high)[..., None] * torch.exp(-beta * e * e)


def geometry(positions: torch.Tensor, nlist: torch.Tensor, edges: torch.Tensor, count: int,
             low: float, high: float) -> Geometry:
    """The ``Geometry`` of a graph and its atoms' ``positions`` f32[N, 3] nm."""
    n, k = nlist.shape
    d, unit = edge_geometry(positions, nlist, edges, high)
    edge = (edges > 0) & (d < high)
    zero = torch.zeros((n, 1), dtype=d.dtype, device=d.device)
    d0 = torch.cat([d, zero], 1)  # the self term at d = 0: C = 1
    idx = torch.arange(n, device=nlist.device)
    width = (count + 1 + 7) // 8 * 8  # the functions and the ones column, to a multiple of 8
    basis = torch.zeros((n, k + 1, width), dtype=d.dtype, device=d.device)
    basis[..., :count] = expnorm_basis(d0, count, low, high)
    basis[..., count] = 1.0
    return Geometry(
        nlist=torch.cat([torch.where(edge, nlist.long(), n), idx[:, None]], 1),
        basis=basis, cut=cosine_cutoff(d0, high),
        unit=torch.cat([unit, torch.zeros((n, 1, 3), dtype=d.dtype, device=d.device)], 1))


def _padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a row of zeros appended (row N: where slots that are no
    edge point)."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _with_bias(p: dict, width: int) -> torch.Tensor:
    """[width, C]: Dense ``p``'s kernel [R, C], its bias as row R, zero rows
    after: the kernel of a product with ``Geometry.basis``."""
    kernel = p["kernel"]
    pad = kernel.new_zeros((width - kernel.shape[0] - 1, kernel.shape[1]))
    return torch.cat([kernel, p["bias"][None], pad])


def _by_part(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``t``'s last axis of 3F, ordered (head, part, dim), reordered (part,
    head, dim)."""
    *lead, c = t.shape
    return t.reshape(*lead, heads, 3, c // (3 * heads)).transpose(-3, -2).reshape(*lead, c)


def layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis: ``p`` {weight [F], bias [F]}."""
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], LN_EPS)


def neighbor_embedding(p: dict, x: torch.Tensor, atoms: torch.Tensor, geo: Geometry,
                       dense, compute_dtype=torch.float32, block: int = BLOCK_ROWS):
    """x [N, F] after NeighborEmbedding: ``p`` {"embed" {kernel [V, F]},
    "dist" Dense(R, F), "combine" Dense(2F, F)}, over the graph's edges
    (not the self term)."""
    n, F = x.shape
    k = geo.nlist.shape[1] - 1
    nb = _padded(dense(p["embed"], atoms))  # a one-hot row selects a row
    kernel = as_operand(_with_bias(p["dist"], geo.basis.shape[-1]), compute_dtype)
    agg = torch.empty_like(x)
    for r0 in range(0, n, block):
        rows = slice(r0, r0 + block)
        w = as_operand(geo.basis[rows, :k], compute_dtype) @ kernel
        agg[rows] = w.mul_(geo.cut[rows, :k, None]).mul_(nb[geo.nlist[rows, :k]]).sum(1)
    return dense(p["combine"], torch.cat([x, agg], -1), None, compute_dtype)


def update_in(p: dict, x: torch.Tensor, vec: torch.Tensor, dense,
              compute_dtype=torch.float32):
    """A layer's steps before the attention: (q [N, F], k [N, F], v [N, 3F],
    u3 [N, 3, F], vec_dot [N, F])."""
    F = x.shape[-1]
    y = layer_norm(p["norm"], x)
    q, k, v = (dense(p[name], y, None, compute_dtype) for name in ("q", "k", "v"))
    u1, u2, u3 = dense(p["vec"], vec, None, compute_dtype).split(F, -1)
    return q, k, v, u3, (u1 * u2).sum(1)


def attention(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, vec: torch.Tensor,
              geo: Geometry, heads: int, activation, compute_dtype=torch.float32,
              block: int = BLOCK_ROWS):
    """(Sx [N, F], Sv [N, 3, F]): the attention stage over the slots of
    ``geo`` (the graph's and the self term), in blocks of ``block`` rows.
    ``p`` {"dk" Dense(R, F), "dv" Dense(R, 3F)}; ``v`` [N, 3F] as
    Dense(F, 3F) gives it."""
    n, F = q.shape
    D = F // heads
    width = geo.basis.shape[-1]
    w_dk = as_operand(_with_bias(p["dk"], width), compute_dtype)                    # [R', F]
    w_dv = as_operand(_by_part(_with_bias(p["dv"], width), heads), compute_dtype)  # [R', 3F]
    k, v, vec = _padded(k), _padded(_by_part(v, heads)), _padded(vec)
    sx, sv = torch.empty_like(q), torch.empty((n, 3, F), dtype=q.dtype, device=q.device)
    for r0 in range(0, n, block):
        rows = slice(r0, r0 + block)
        nl = geo.nlist[rows]
        b, s = nl.shape
        f = as_operand(geo.basis[rows], compute_dtype)
        logit = activation(f @ w_dk).mul_(k[nl]).mul_(q[rows, None]).view(b, s, heads, D).sum(-1)
        a = activation(logit).mul_(geo.cut[rows, :, None])             # [b, s, H]
        val = activation(f @ w_dv).mul_(v[nl]).view(b, s, 3, F)        # s, m1, m2
        sx[rows] = val[:, :, 0].view(b, s, heads, D).mul_(a[..., None]).sum(1).view(b, F)
        sv[rows] = (vec[nl].mul_(val[:, :, 1:2]).sum(1)
                    + torch.matmul(geo.unit[rows].transpose(1, 2), val[:, :, 2]))
    return sx, sv


def kernel_args(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                vec: torch.Tensor, geo: Geometry, heads: int, activation,
                compute_dtype=torch.float32):
    """The operands of a launch of ``fused_attention``'s kernel, checked, in
    its order (q, k, v, vec, nlist, basis, cut, unit, dk's kernel and bias,
    dv's kernel and bias), and its sizes (N, K + 1, H, D, R, the basis
    width R'). Raises on what the kernel does not take: an activation
    other than SiLU, a compute type other than float32 or bfloat16, D =
    F / H other than 16, 32 or 64, more than ``MAX_FUNCTIONS`` radial
    functions or ``MAX_SLOTS`` slots a row, a basis width under R + 1 or
    not a multiple of 4, an operand of another shape or type, or off
    ``q``'s device. ``v`` and dv's columns stay as Dense(F, 3F) orders
    them, (head, part, dim)."""
    if activation is not torch.nn.functional.silu:
        raise ValueError(f"et kernel: activation {activation!r}; it takes SiLU only")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"et kernel: compute_dtype {compute_dtype}; it takes float32 or "
                        f"bfloat16 operands")
    if q.dim() != 2 or heads < 1 or q.shape[1] % heads:
        raise ValueError(f"et kernel: q {tuple(q.shape)} in {heads} heads")
    (n, F), D = q.shape, q.shape[1] // heads
    if D not in HEAD_WIDTHS:
        raise ValueError(f"et kernel: heads of {D} features; it takes {HEAD_WIDTHS}")
    if geo.nlist.dim() != 2 or geo.basis.dim() != 3:
        raise ValueError(f"et kernel: nlist {tuple(geo.nlist.shape)} and basis "
                         f"{tuple(geo.basis.shape)} must be 2-D and 3-D")
    S, width = geo.nlist.shape[1], geo.basis.shape[2]
    R = p["dk"]["kernel"].shape[0]
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"et kernel: {S} slots a row; it takes 1 to {MAX_SLOTS}")
    if not 1 <= R <= MAX_FUNCTIONS:
        raise ValueError(f"et kernel: {R} radial functions; it takes 1 to {MAX_FUNCTIONS}")
    if width % 4 or width < R + 1:
        raise ValueError(f"et kernel: basis width {width}; it takes a multiple of 4 of at "
                         f"least R + 1 = {R + 1}")
    ops = {"q": (q, (n, F)), "k": (k, (n, F)), "v": (v, (n, 3 * F)), "vec": (vec, (n, 3, F)),
           "nlist": (geo.nlist, (n, S)), "basis": (geo.basis, (n, S, width)),
           "cut": (geo.cut, (n, S)), "unit": (geo.unit, (n, S, 3)),
           "dk kernel": (p["dk"]["kernel"], (R, F)), "dk bias": (p["dk"]["bias"], (F,)),
           "dv kernel": (p["dv"]["kernel"], (R, 3 * F)), "dv bias": (p["dv"]["bias"], (3 * F,))}
    out = []
    for name, (t, shape) in ops.items():
        t = t.contiguous()
        check(f"et kernel: {name}", t, torch.int64 if name == "nlist" else torch.float32,
              shape, q.device)
        out.append(t)
    return out, (n, S, heads, D, R, width)


def _recording(p, q, k, v, vec, geo, heads, activation, compute_dtype=torch.float32,
               block=BLOCK_ROWS):
    """``attention`` for a call on the card while autograd records: grad
    mode on and an operand that requires grad."""
    ops = (q, k, v, vec, geo.basis, geo.cut, geo.unit, *p["dk"].values(), *p["dv"].values())
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return attention
    return None


@kernel(attention, on="q", route=_recording)
def fused_attention(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    vec: torch.Tensor, geo: Geometry, heads: int, activation,
                    compute_dtype=torch.float32, block: int = BLOCK_ROWS):
    """(Sx [N, F], Sv [N, 3, F]): ``attention``'s stage, with its arguments
    (``block`` is the plain version's alone). On the card one launch of
    ``csrc/et.cu`` over the real slots (``kernel_args`` says what it
    takes; others raise), counted in ``.launches``, or ``attention`` while
    autograd records; on the CPU ``attention``."""
    ops, (n, S, H, D, R, width) = kernel_args(p, q, k, v, vec, geo, heads, activation,
                                              compute_dtype)
    sx = torch.empty((n, H * D), dtype=torch.float32, device=q.device)
    sv = torch.empty((n, 3, H * D), dtype=torch.float32, device=q.device)
    launch("nmr_et_attention", q.device, *(t.data_ptr() for t in ops), sx.data_ptr(),
           sv.data_ptr(), n, S, H, D, R, width, int(compute_dtype == torch.bfloat16))
    return sx, sv


def update_out(p: dict, x: torch.Tensor, vec: torch.Tensor, sx: torch.Tensor,
               sv: torch.Tensor, u3: torch.Tensor, vec_dot: torch.Tensor, dense,
               compute_dtype=torch.float32):
    """(x, v_state) after a layer: the o projection and the residuals."""
    F = x.shape[-1]
    o1, o2, o3 = dense(p["o"], sx, None, compute_dtype).split(F, -1)
    return x + vec_dot * o2 + o3, vec + u3 * o1[:, None, :] + sv
