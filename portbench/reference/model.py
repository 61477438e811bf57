"""Plain PyTorch reference of the nmrgnn model (ur-whitelab/nmrgnn): the
gather forward of the bilinear (MPLayer) and attention (AMPLayer)
families, in float32, written from the published description.

    mask  = distance > 0
    e     = EdgeFC(RBF(distance) * mask) * mask     hidden Dense(H, act) layers, then Dense(E)
    x     = one_hot @ W_embed
    x     = x + MP(x, e)                            once per MP layer
    x     = FC block                                residual Dense(F, act) layers, then Dense(F/2, act)
    peaks = sum(((x @ W_out + b) * std + avg) * one_hot, -1)

Bilinear MP: act(inv_degree * sum_{j,n,l} e[i,j,n] x[nlist[i,j],l] w[l,m,n]).
Attention MP: act(sum_j softmax_j(inv_degree * <e[i,j] @ wk, x[i] @ wq>)
x[nlist[i,j]] @ wv), over all K slots. RBF centers are
linspace(low, high, H); the expansion is exp(-(d - mu)^2 / gap) with gap
the centers' spacing. softplus is max(x, 0) + log1p(exp(-|x|)).

Every product goes through ``Products``: float32 (TF32 off) or, for the
control that decides ``correct``, its operands rounded to TF32's 10-bit
mantissa first, with float32 sums, as a TF32 tensor-core product is.
"""
from __future__ import annotations

import numpy as np
import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest value with a 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class Products:
    """The products of the reference: float32 with TF32 off, or
    (``tf32=True``) operands rounded to TF32 first."""

    def __init__(self, tf32: bool = False):
        _no_tf32()
        self.tf32 = tf32

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """The operand as the product sees it."""
        return tf32_round(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(spec, self.op(a), self.op(b))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def activation(name: str):
    acts = {"softplus": softplus, "relu": torch.relu, "tanh": torch.tanh,
            "linear": lambda x: x}
    return acts[name]


def rbf(d: torch.Tensor, low: float, high: float, count: int) -> torch.Tensor:
    centers = torch.as_tensor(np.linspace(low, high, count).astype(np.float32), device=d.device)
    gap = centers[1] - centers[0]
    diff = d[..., None] - centers
    return torch.exp(-(diff * diff) / gap)


def edge_features(p: dict, cfg: dict, d: torch.Tensor, mask: torch.Tensor,
                  prod: Products) -> torch.Tensor:
    """f32[..., K, E] for distances ``d`` [..., K] and ``mask`` [..., K]."""
    act = activation(cfg["fc_activation"])
    x = rbf(d, cfg["rbf_low"], cfg["rbf_high"], cfg["edge_hidden_size"]) * mask[..., None]
    for layer in p["edge_fc"][:-1]:
        x = act(prod.mm(x, layer["kernel"]) + layer["bias"])
    last = p["edge_fc"][-1]
    return (prod.mm(x, last["kernel"]) + last["bias"]) * mask[..., None]


def _gather(x: torch.Tensor, nlist: torch.Tensor) -> torch.Tensor:
    """x[..., nlist, :] per graph of a leading batch axis (or none)."""
    if x.dim() == 2:
        return x[nlist.long()]
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, nlist.long()]


def mp_bilinear(w, x, nlist, e, inv_degree, act, prod: Products):
    h = prod.einsum("...jn,...jl->...nl", e, _gather(x, nlist))
    out = prod.einsum("...nl,lmn->...m", h, w)
    return act(out * inv_degree[..., None])


def mp_attention(wq, wk, wv, x, nlist, e, inv_degree, act, prod: Products):
    query = prod.mm(x, wq)                                       # [..., N, E]
    keys = prod.mm(e, wk)                                        # [..., N, K, E]
    logits = inv_degree[..., None] * prod.einsum("...jk,...k->...j", keys, query)
    weights = torch.softmax(logits, dim=-1)
    values = prod.mm(x, wv)                                      # once per atom
    return act(prod.einsum("...j,...jm->...m", weights, _gather(values, nlist)))


def forward(p: dict, cfg: dict, atoms, nlist, edges, inv_degree, prod: Products = None,
            edge_block: int = 8192) -> torch.Tensor:
    """Peaks f32[..., N] of one graph [N, ...] or a batch [B, N, ...]. The
    edge stage runs in blocks of ``edge_block`` rows so that it fits at
    any size."""
    prod = prod or Products()
    mask = (edges > 0).to(torch.float32)
    d = edges
    if d.dim() == 2 and d.shape[0] > edge_block:
        e = torch.cat([edge_features(p, cfg, d[i:i + edge_block], mask[i:i + edge_block], prod)
                       for i in range(0, d.shape[0], edge_block)])
    else:
        e = edge_features(p, cfg, d, mask, prod)
    mp_act = activation(cfg["mp_activation"])
    x = atoms @ p["embed"]["kernel"]  # a one-hot row selects a row: exact
    for layer in p["mp"]:
        if cfg["mp_type"] == "attention":
            upd = mp_attention(layer["wq"], layer["wk"], layer["wv"], x, nlist, e, inv_degree,
                               mp_act, prod)
        else:
            upd = mp_bilinear(layer["w"], x, nlist, e, inv_degree, mp_act, prod)
        x = upd + x
    fc_act = activation(cfg["fc_activation"])
    for layer in p["fc"][:-1]:
        x = fc_act(prod.mm(x, layer["kernel"]) + layer["bias"]) + x
    x = fc_act(prod.mm(x, p["fc"][-1]["kernel"]) + p["fc"][-1]["bias"])
    full = prod.mm(x, p["out"]["kernel"]) + p["out"]["bias"]
    return torch.sum((full * p["peak_std"] + p["peak_avg"]) * atoms, dim=-1)
