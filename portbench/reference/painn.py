"""Plain PyTorch reference of PaiNN (Schütt, Unke and Gastegger, ICML 2021,
arXiv:2102.03150; schnetpack ``representation/painn.py``) for the
``painn`` configuration, in float32 (TF32 off), written from the paper's
equations:

    r_ij = x_j - x_i,  d = |r_ij|,  r^ = r_ij / d
    W    = (phi(d) @ K_filter + b_filter) * f_cut(d),  one 3F slice a block
           phi_n = sin(n pi d_A / r_c) / d_A (n = 1..R, d_A = 10 d in Angstrom)
           f_cut = (cos(pi d / r_c) + 1) / 2 below r_c, else 0
    message: (a, b, c) = W_ij * phi_ctx(s)_j      phi_ctx = Dense(F, 3F) o SiLU o Dense(F, F)
             s_i += sum_j a,  v_i += sum_j (b r^_ij + c v_j)
    update:  V, U = v @ W_V, v @ W_U             (W_mix = [W_V | W_U], no bias)
             (a, b, c) = Dense(F, 3F)(SiLU(Dense(2F, F)([s, sqrt(sum_xyz V^2 + 1e-8)])))
             v += b U,  s += a + c sum_xyz(V U)
    v starts at 0; then nmrgnn's readout (``model.py``'s FC block and head).

Departures from schnetpack: nmrgnn's per-element head in place of
``Atomwise`` (a shift an atom: Dense(F, F/2, SiLU), Dense(F/2, V), the
atom's own element's output times its peak std plus its mean); a one-hot
row over nmrgnn's V = 10 element vocabulary in place of ``nn.Embedding``
over atomic numbers; a padded list of K = 80 slots an atom (a slot of
graph distance 0 is padding and adds nothing), distances in nm.

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


def forward(p: dict, cfg: dict, atoms, nlist, edges, positions, prod: Products = None,
            block: int = 4096) -> torch.Tensor:
    """Peaks f32[N] of one structure: ``atoms`` f32[N, V] one-hot, ``nlist``
    [N, K], ``edges`` f32[N, K] nm (0: padding), ``positions`` f32[N, 3] nm."""
    prod = prod or Products()

    def dense(layer, x):
        y = prod.mm(x, layer["kernel"])
        return y + layer["bias"] if "bias" in layer else y

    F, R, rc = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["rbf_high"]
    n = atoms.shape[0]
    nl = nlist.long()
    real = edges > 0
    freq = torch.arange(1, R + 1, dtype=torch.float32, device=atoms.device) * math.pi / rc
    s = atoms @ p["embed"]["kernel"]  # a one-hot row selects a row: exact
    v = torch.zeros((n, 3, F), dtype=torch.float32, device=atoms.device)
    for i, blk in enumerate(p["mp"]):
        cols = slice(3 * F * i, 3 * F * (i + 1))
        filt = {"kernel": p["filter"]["kernel"][:, cols], "bias": p["filter"]["bias"][cols]}
        ctx = dense(blk["context"][1], silu(dense(blk["context"][0], s)))
        ds = torch.zeros_like(s)
        dv = torch.zeros_like(v)
        for r0 in range(0, n, block):
            rows = slice(r0, r0 + block)
            j, m = nl[rows], real[rows]
            r = positions[j] - positions[rows][:, None, :]
            d = torch.sqrt((r * r).sum(-1))
            safe = torch.where(m, d, torch.ones_like(d))
            unit = torch.where(m[..., None], r / safe[..., None], torch.zeros_like(r))
            phi = torch.sin(safe[..., None] * freq) / (10.0 * safe[..., None])
            fcut = torch.where(m & (d < rc), 0.5 * (torch.cos(math.pi * d / rc) + 1.0),
                               torch.zeros_like(d))
            x = dense(filt, phi) * fcut[..., None] * ctx[j]
            a, b, c = x[..., :F], x[..., F:2 * F], x[..., 2 * F:]
            ds[rows] = a.sum(1)
            dv[rows] = ((unit[..., None] * b[:, :, None, :]).sum(1)
                        + (c[:, :, None, :] * v[j]).sum(1))
        s, v = s + ds, v + dv
        vv = prod.mm(v, blk["channel_mix"]["kernel"])
        V, U = vv[..., :F], vv[..., F:]
        norm = torch.sqrt((V * V).sum(1) + 1e-8)
        x = dense(blk["mix"][1], silu(dense(blk["mix"][0], torch.cat([s, norm], -1))))
        a, b, c = x[..., :F], x[..., F:2 * F], x[..., 2 * F:]
        v = v + b[:, None, :] * U
        s = s + a + c * (V * U).sum(1)
    for layer in p["fc"][:-1]:
        s = silu(dense(layer, s)) + s
    s = silu(dense(p["fc"][-1], s))
    full = dense(p["out"], s)
    return torch.sum((full * p["peak_std"] + p["peak_avg"]) * atoms, dim=-1)
