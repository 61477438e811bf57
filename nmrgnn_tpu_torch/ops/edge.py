"""The edge stage: RBF expansion of the distances, then the EdgeFC MLP,
masked by ``distance > 0`` before and after (``nmrgnn_tpu/models/
infer.py:127-145``). The plain gather forward and the plain version of
the fused edge-band kernel both use it.

``as_operand`` emulates a matrix product in a narrower compute type with
float32 accumulation (``jnp.matmul(x.astype(cd), k.astype(cd),
preferred_element_type=float32)``): both operands are rounded to the
compute type and held in float32, so every product is exact and every sum
is float32."""
from __future__ import annotations

from typing import Sequence

import torch

from .activations import get_activation
from .rbf import rbf_expand


def as_operand(x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held in float32 (``x`` itself
    for float32)."""
    return x if compute_dtype == torch.float32 else x.to(compute_dtype).float()


def edge_features(
    edges: torch.Tensor,             # f32[N, K] distances, 0 on padding slots
    edge_fc_params: Sequence[dict],  # [{"kernel", "bias"}], models/gnn layout
    *,
    rbf_low: float,
    rbf_high: float,
    activation_name: str = "softplus",
    compute_dtype=torch.float32,
    mask=None,
) -> torch.Tensor:
    """f32[N, K, E]: (edge_fc_layers - 1) x Dense(H, act), then a linear
    Dense(E), over the H-wide RBF expansion; the products' operands in
    ``compute_dtype``, biases and activations in float32.

    ``mask`` (f32[N, K, 1]) overrides the padding mask ``edges > 0``: a
    caller that adds training noise to the distances passes the mask of
    the distances before the noise, as the reference masks them
    (``nmrgnn_tpu/models/infer.py:127-139``)."""
    act = get_activation(activation_name)
    if mask is None:
        mask = (edges > 0).to(torch.float32)[..., None]
    h = edge_fc_params[-1]["kernel"].shape[0]
    x = rbf_expand(edges, rbf_low, rbf_high, h) * mask
    op = lambda a: as_operand(a, compute_dtype)  # noqa: E731
    for p in edge_fc_params[:-1]:
        x = act(op(x) @ op(p["kernel"]) + p["bias"])
    x = op(x) @ op(edge_fc_params[-1]["kernel"]) + edge_fc_params[-1]["bias"]
    return x * mask
