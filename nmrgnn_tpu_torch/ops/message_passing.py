"""Gather message passing (``nmrgnn_tpu/ops/message_passing.py:31-71``):
the plain oracle of the banded operator.

    out[i, m] = act( sum_{j,n,l} edges[i,j,n] * nodes[nlist[i,j], l]
                                 * w[l, m, n] * inv_degree[i] )

The small neighbor axis is contracted first, then E dense [N,F]x[F,F]
products. With a narrower ``compute_dtype`` the operands of both products
are rounded to it, h is rounded to it between them (the first product's
result type), and the sums are float32.
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
