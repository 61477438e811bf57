"""The GNN chemical-shift model (``nmrgnn_tpu/models/gnn.py:43-245``):
parameter init and the inference-mode forward, as plain functions over a
dict of tensors in the JAX package's layout.

  edge_mask = (edges > 0)
  e = RBF(edges) * edge_mask
  e = EdgeFC(e) * edge_mask            (edge_fc_layers - 1) x Dense(H, act), Dense(E)
  nodes = atoms @ W_embed              (no bias)
  nodes = nodes + MPLayer(nodes, ...)  mp_layers x
  nodes = FCBlock(nodes)               (fc_layers - 1) x (Dense(F, act) + residual),
                                       then Dense(F // 2, act)
  full_peaks = nodes @ W_out + b_out
  peaks = sum(full_peaks * atoms * peak_std + atoms * peak_avg, -1)

Parameter layout: {"embed": {"kernel"}, "edge_fc": [{"kernel", "bias"}],
"mp": [{"w": [F, F, E]}], "fc": [...], "out": {...}, "peak_std",
"peak_avg"}. Training (noise, dropout) is a later slice.

``config.compute_dtype`` ("float32" or "bfloat16") sets the operand type
of the products, with float32 sums, as in the JAX package: the edge stage,
the MP layers and the FC block, but not the embedding nor, in this gather
forward, the per-element head (``nmrgnn_tpu/models/gnn.py:181-214``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..graph import Graph
from ..ops import edge
from ..ops.edge import as_operand
from ..ops.activations import get_activation
from ..ops.message_passing import mp_layer

Params = Dict[str, Any]


def _glorot(gen: torch.Generator, shape, fan_in: int, fan_out: int) -> torch.Tensor:
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (2 * limit) - limit


def _dense_init(gen, d_in: int, d_out: int, use_bias: bool = True) -> dict:
    p = {"kernel": _glorot(gen, (d_in, d_out), d_in, d_out)}
    if use_bias:
        p["bias"] = torch.zeros((d_out,), dtype=torch.float32)
    return p


def compute_dtype(config: ModelConfig) -> torch.dtype:
    """The torch dtype named by ``config.compute_dtype``."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if config.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {config.compute_dtype!r}: takes {sorted(dtypes)}")
    return dtypes[config.compute_dtype]


def dense(p: dict, x: torch.Tensor, activation=None,
          compute_dtype=torch.float32) -> torch.Tensor:
    """Dense layer; the product's operands in ``compute_dtype``, its sum,
    the bias and the activation in float32."""
    y = as_operand(x, compute_dtype) @ as_operand(p["kernel"], compute_dtype)
    if "bias" in p:
        y = y + p["bias"]
    return activation(y) if activation is not None else y


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a params tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    peak_standards: Optional[Dict[int, tuple]] = None,
    device="cuda",
) -> Params:
    """Keras-default initialization (glorot-uniform kernels, zero biases),
    drawn on the CPU from ``generator`` and moved to ``device``. The MP
    weight w[F, F, E] takes the rank-3 glorot fan of Keras: fan_in = F*F,
    fan_out = E*F. ``peak_standards`` maps element index -> (name, avg,
    std); peak_std defaults to 1 and peak_avg to 0."""
    if config.mp_type != "bilinear":
        raise NotImplementedError(
            "mp_type='attention' is a later slice of the port (ROADMAP queue A3/A6)"
        )
    dev = resolve_device(device)
    F, E, H, V = (config.atom_feature_size, config.edge_feature_size,
                  config.edge_hidden_size, config.num_elements)
    edge_fc = [_dense_init(generator, H, H) for _ in range(config.edge_fc_layers - 1)]
    edge_fc.append(_dense_init(generator, H, E))
    mp = [{"w": _glorot(generator, (F, F, E), F * F, E * F)}
          for _ in range(config.mp_layers)]
    fc = [_dense_init(generator, F, F) for _ in range(config.fc_layers - 1)]
    fc.append(_dense_init(generator, F, F // 2))
    peak_std = torch.ones((V,), dtype=torch.float32)
    peak_avg = torch.zeros((V,), dtype=torch.float32)
    for k, v in (peak_standards or {}).items():
        if k < V:
            peak_std[k] = v[2]
            peak_avg[k] = v[1]
    params = {
        "embed": _dense_init(generator, V, F, use_bias=False),
        "edge_fc": edge_fc,
        "mp": mp,
        "fc": fc,
        "out": _dense_init(generator, F // 2, V),
        "peak_std": peak_std,
        "peak_avg": peak_avg,
    }
    return tree_map(lambda t: t.to(dev), params)


def edge_features(params: Params, config: ModelConfig, edges: torch.Tensor) -> torch.Tensor:
    """f32[N, K, E]: RBF + EdgeFC, masked by ``edges > 0`` before and after;
    the EdgeFC products in the compute type."""
    return edge.edge_features(edges, params["edge_fc"], rbf_low=config.rbf_low,
                              rbf_high=config.rbf_high,
                              activation_name=config.fc_activation,
                              compute_dtype=compute_dtype(config))


def readout(params: Params, config: ModelConfig, atoms: torch.Tensor,
            nodes: torch.Tensor, head_dtype=torch.float32) -> torch.Tensor:
    """FC block (products in the compute type), per-element head (products
    in ``head_dtype``) and de-standardization -> peaks f32[N]."""
    fc_act = get_activation(config.fc_activation)
    cd = compute_dtype(config)
    for p in params["fc"][:-1]:
        nodes = dense(p, nodes, fc_act, cd) + nodes
    nodes = dense(params["fc"][-1], nodes, fc_act, cd)
    full_peaks = dense(params["out"], nodes, compute_dtype=head_dtype)
    return torch.sum(
        full_peaks * atoms * params["peak_std"] + atoms * params["peak_avg"], dim=-1
    )


def apply(params: Params, config: ModelConfig, graph: Graph) -> torch.Tensor:
    """Inference-mode forward for one graph of tensors; peaks f32[N].
    The plain gather forward: the reference every faster path is held to."""
    atoms, nlist, edges, inv_degree = graph
    mp_act = get_activation(config.mp_activation)
    cd = compute_dtype(config)
    e = edge_features(params, config, edges)
    nodes = dense(params["embed"], atoms)
    for p in params["mp"]:
        nodes = mp_layer(p["w"], nodes, nlist, e, inv_degree, mp_act, cd) + nodes
    return readout(params, config, atoms, nodes)


def count_params(params: Params) -> int:
    """Trainable parameters (peak_std / peak_avg are frozen buffers)."""
    sizes = []
    trainable = {k: v for k, v in params.items() if k not in ("peak_std", "peak_avg")}
    tree_map(lambda t: sizes.append(int(np.prod(tuple(t.shape)))), trainable)
    return sum(sizes)
