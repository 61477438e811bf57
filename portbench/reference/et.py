"""Plain PyTorch reference of TorchMD-Net's equivariant transformer
(Thölke and De Fabritiis, ICLR 2022, arXiv:2202.02541; torchmd-net
``models/torchmd_et.py``, ``models/utils.py``) for the ``torchmd-et``
configuration, in float32 (TF32 off), written from the paper's equations
and torchmd-net:

    r^_ij = (x_j - x_i) / d_ij;  d in Angstrom (10 x the graph's nm)
    C(d)  = (cos(pi d / r_c) + 1) / 2 below r_c, else 0
    f_ij  = C(d) exp(-beta (exp(-alpha (d - r_l)) - mu_n)^2),  n = 1..R
            alpha = 5 / (r_c - r_l), mu = linspace(exp(r_l - r_c), 1, R),
            beta = (2 / R (1 - exp(r_l - r_c)))^-2
    x = one_hot @ E
    x = W_c [x, sum_{j != i} (W_d f_ij + b_d) C(d_ij) (one_hot_j @ E_nb)] + b_c
    v = 0 [N, 3, F]; then each layer, over the edges j of i and i itself
    (d_ii = 0, C = 1, r^_ii = 0), H heads of D = F / H:
        y = LayerNorm(x);  q, k = W_q y + b_q, W_k y + b_k;  val = W_v y + b_v [H, 3D]
        u1, u2, u3 = v W_vec  (F each);  vec_dot = sum_xyz u1 u2
        dk = SiLU(W_dk f + b_dk) [H, D];  dv = SiLU(W_dv f + b_dv) [H, 3D]
        a_ij = SiLU(sum_d q_i k_j dk_ij) C(d_ij)            each head
        s, m1, m2 = split(val_j dv_ij, D)
        X_i = sum_j a_ij s;  V_i = sum_j (v_j m1 + m2 r^_ij)
        o1, o2, o3 = split(W_o X + b_o, F)
        x = x + vec_dot o2 + o3;  v = v + u3 o1 + V
    x = LayerNorm_out(x); then nmrgnn's readout (``model.py``'s FC block
    and head).

Departures from torchmd-net: nmrgnn's per-element head in place of the
output model (a shift an atom: Dense(F, F/2, SiLU), Dense(F/2, V), the
atom's own element's output times its peak std plus its mean); one-hot
rows over nmrgnn's V = 10 element vocabulary in place of
``nn.Embedding(max_z)``; a padded list of K = 80 slots an atom in place of
``max_num_neighbors`` (above every atom's count within r_c in the cell,
so the cap drops nothing): a slot of graph distance 0 is padding and a
slot at or past r_c no edge, and neither adds anything.

Every Dense product goes through ``model.Products``: float32, or for the
control that decides ``correct`` its operands rounded to TF32 first. The
per-edge terms run in blocks of ``block`` atoms so that the reference fits
at the cell's size.
"""
from __future__ import annotations

import math

import torch

from .model import Products


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p["weight"] + p["bias"]


def forward(p: dict, cfg: dict, atoms, nlist, edges, positions, prod: Products = None,
            block: int = 1024) -> torch.Tensor:
    """Peaks f32[N] of one structure: ``atoms`` f32[N, V] one-hot, ``nlist``
    [N, K], ``edges`` f32[N, K] nm (0: padding), ``positions`` f32[N, 3] nm."""
    prod = prod or Products()

    def dense(layer, x):
        y = prod.mm(x, layer["kernel"])
        return y + layer["bias"] if "bias" in layer else y

    F, R, H = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["edge_feature_size"]
    D = F // H
    rl, rc = 10.0 * cfg["rbf_low"], 10.0 * cfg["rbf_high"]  # Angstrom
    dev = atoms.device
    n = atoms.shape[0]
    start = math.exp(rl - rc)
    mu = torch.linspace(start, 1.0, R, dtype=torch.float32, device=dev)
    beta = (2.0 / R * (1.0 - start)) ** -2
    alpha = 5.0 / (rc - rl)
    pos = positions * 10.0

    # each block of rows: its atoms, their neighbors, which slots are edges,
    # C, f and r^ of each slot
    blocks = []
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(r0 + block, n), device=dev)
        j = nlist[rows].long()
        r = pos[j] - pos[rows][:, None, :]
        d = torch.sqrt((r * r).sum(-1))
        edge = (edges[rows] > 0) & (d < rc)
        safe = torch.where(edge, d, torch.ones_like(d))
        unit = torch.where(edge[..., None], r / safe[..., None], torch.zeros_like(r))
        cut = torch.where(edge, 0.5 * (torch.cos(math.pi * safe / rc) + 1.0),
                          torch.zeros_like(d))
        basis = cut[..., None] * torch.exp(
            -beta * (torch.exp(-alpha * (safe - rl))[..., None] - mu) ** 2)
        blocks.append((rows, j, edge, cut, basis, unit))

    x = atoms @ p["embed"]["kernel"]  # a one-hot row selects a row: exact
    nb = p["neighbor"]
    e_nb = atoms @ nb["embed"]["kernel"]
    agg = torch.zeros_like(x)
    for rows, j, edge, cut, basis, unit in blocks:
        agg[rows] = (dense(nb["dist"], basis) * cut[..., None] * e_nb[j]).sum(1)
    x = dense(nb["combine"], torch.cat([x, agg], -1))

    f_self = torch.exp(-beta * (1.0 - mu) ** 2)[None]  # d = 0, C = 1
    v = torch.zeros((n, 3, F), dtype=torch.float32, device=dev)
    for layer in p["mp"]:
        y = _layer_norm(layer["norm"], x)
        q = dense(layer["q"], y).view(n, H, D)
        k = dense(layer["k"], y).view(n, H, D)
        val = dense(layer["v"], y).view(n, H, 3 * D)
        u = prod.mm(v, layer["vec"]["kernel"])
        u1, u2, u3 = u[..., :F], u[..., F:2 * F], u[..., 2 * F:]
        vec_dot = (u1 * u2).sum(1)
        vh = v.view(n, 3, H, D)
        X = torch.zeros((n, H, D), dtype=torch.float32, device=dev)
        V = torch.zeros((n, 3, H, D), dtype=torch.float32, device=dev)
        for rows, j, edge, cut, basis, unit in blocks:
            dk = silu(dense(layer["dk"], basis)).view(*j.shape, H, D)
            dv = silu(dense(layer["dv"], basis)).view(*j.shape, H, 3 * D)
            a = silu((q[rows][:, None] * k[j] * dk).sum(-1)) * cut[..., None]
            m = val[j] * dv * edge[..., None, None]
            s, m1, m2 = m[..., :D], m[..., D:2 * D], m[..., 2 * D:]
            X[rows] = (a[..., None] * s).sum(1)
            V[rows] = ((vh[j] * m1[:, :, None]).sum(1)
                       + (m2[:, :, None] * unit[..., None, None]).sum(1))
        dk = silu(dense(layer["dk"], f_self)).view(H, D)
        dv = silu(dense(layer["dv"], f_self)).view(H, 3 * D)
        m = val * dv
        X = X + silu((q * k * dk).sum(-1))[..., None] * m[..., :D]
        V = V + vh * m[:, None, :, D:2 * D]
        o = dense(layer["o"], X.reshape(n, F))
        o1, o2, o3 = o[:, :F], o[:, F:2 * F], o[:, 2 * F:]
        x = x + vec_dot * o2 + o3
        v = v + u3 * o1[:, None, :] + V.reshape(n, 3, F)
    x = _layer_norm(p["out_norm"], x)
    for layer in p["fc"][:-1]:
        x = silu(dense(layer, x)) + x
    x = silu(dense(p["fc"][-1], x))
    full = dense(p["out"], x)
    return torch.sum((full * p["peak_std"] + p["peak_avg"]) * atoms, dim=-1)
