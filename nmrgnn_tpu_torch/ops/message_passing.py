"""Gather message passing (``nmrgnn_tpu/ops/message_passing.py``): the
plain oracle of the banded operators.

    out[i, m] = act( sum_{j,n,l} edges[i,j,n] * nodes[nlist[i,j], l]
                                 * w[l, m, n] * inv_degree[i] )

The small neighbor axis is contracted first, then E dense [N,F]x[F,F]
products. With a narrower ``compute_dtype`` the operands of both products
are rounded to it, h is rounded to it between them (the first product's
result type), and the sums are float32.

The attention layer (AMPLayer, ``:74-115``) takes a softmax over each
atom's K neighbor slots, padding slots included (the reference's quirk:
a padding slot gets weight and sends the row its index names), with the
logits scaled by inv_degree; it is float32 throughout, whatever the
compute type, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch

from .activations import softplus
from .edge import as_operand


def mp_aggregate(
    nodes: torch.Tensor,       # f32[N, F]
    nlist: torch.Tensor,       # i32[N, K]
    edges: torch.Tensor,       # f32[N, K, E]
    inv_degree: torch.Tensor,  # f32[N]
    w: torch.Tensor,           # f32[F, F, E]
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Bilinear neighborhood aggregation; f32[N, F] before the activation."""
    op = lambda a: as_operand(a, compute_dtype)  # noqa: E731
    gathered = nodes[nlist.long()]                                # [N, K, F]
    h = op(torch.einsum("ijn,ijl->inl", op(edges), op(gathered)))  # [N, E, F]
    out = torch.einsum("inl,lmn->im", h, op(w))                    # [N, F]
    return out * inv_degree[:, None]


def mp_layer(
    w: torch.Tensor,
    nodes: torch.Tensor,
    nlist: torch.Tensor,
    edges: torch.Tensor,
    inv_degree: torch.Tensor,
    activation: Callable = softplus,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """MPLayer forward: aggregation + activation (no residual)."""
    return activation(mp_aggregate(nodes, nlist, edges, inv_degree, w, compute_dtype))


def attention_weights(
    wq: torch.Tensor,          # f32[F, E]
    wk: torch.Tensor,          # f32[E, E]
    nodes: torch.Tensor,       # f32[N, F]
    edges: torch.Tensor,       # f32[N, K, E] (EdgeFC output)
    inv_degree: torch.Tensor,  # f32[N]
) -> torch.Tensor:
    """Softmax attention weights f32[N, K] over all K slots, padding
    included: logits[i, j] = inv_degree[i] * <edges[i, j] @ wk, nodes[i] @ wq>."""
    query = nodes @ wq                                     # [N, E]
    keys = torch.einsum("ijk,kl->ijl", edges, wk)          # [N, K, E]
    logits = inv_degree[:, None] * torch.einsum("ijk,ik->ij", keys, query)
    return torch.softmax(logits, dim=-1)


def amp_layer(
    wq: torch.Tensor,          # f32[F, E]
    wk: torch.Tensor,          # f32[E, E]
    wv: torch.Tensor,          # f32[F, F]
    nodes: torch.Tensor,       # f32[N, F]
    nlist: torch.Tensor,       # i32[N, K]
    edges: torch.Tensor,       # f32[N, K, E]
    inv_degree: torch.Tensor,  # f32[N]
    activation: Callable = softplus,
) -> torch.Tensor:
    """AMPLayer forward (no residual): act(sum_j a[i, j] * nodes[nlist[i, j]] @ wv)
    with ``a = attention_weights(...)``."""
    values = torch.einsum("ijl,lm->ijm", nodes[nlist.long()], wv)  # [N, K, F]
    attn = attention_weights(wq, wk, nodes, edges, inv_degree)
    return activation(torch.einsum("ij,ijm->im", attn, values))
