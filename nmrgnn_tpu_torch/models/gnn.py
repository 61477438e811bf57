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
"peak_avg"}. An ``mp_type="attention"`` model (the AMPLayer family) holds
``{"wq": [F, E], "wk": [E, E], "wv": [F, F]}`` per MP layer instead, and
its layers are ``ops.message_passing.amp_layer``, float32 whatever the
compute type (``nmrgnn_tpu/models/gnn.py:192-200``), with their
residuals as ``ops.attention.amp``: one kernel a layer on the card where
autograd does not record, ``amp_layer`` where it does.

An ``mp_type="painn"`` model (PaiNN, arXiv:2102.03150; ``ops/painn.py``,
which the JAX package has no counterpart of) reads the atoms' positions
beside the graph (``apply(..., positions=)``, f32[N, 3] nm) and holds
``{"embed", "filter": {kernel [R, B * 3F], bias}, "mp": [{"context":
[Dense(F, F), Dense(F, 3F)], "mix": [Dense(2F, F), Dense(F, 3F)],
"channel_mix": {kernel [F, 2F]}}], "fc", "out", "peak_std", "peak_avg"}``.
Its widths are the config's own fields: F ``atom_feature_size``, B
``mp_layers`` interaction blocks, R ``edge_hidden_size`` radial functions,
the cutoff ``rbf_high`` (nm), ``edge_fc_layers`` 1 (the one filter
Dense), SiLU as ``mp_activation``, and the readout as the other
families'; ``edge_feature_size`` and ``rbf_low`` are unused. It serves
inference only: ``training=True`` raises. Its forward is one
``nmrgnn.filter`` span and one ``nmrgnn.mp`` a block holding
``nmrgnn.message`` and ``nmrgnn.update``.

An ``mp_type="et"`` model (TorchMD-Net's equivariant transformer,
arXiv:2202.02541; ``ops/et.py``) reads the positions as PaiNN does and
holds ``{"embed", "neighbor": {"embed" {kernel [V, F]}, "dist" Dense(R,
F), "combine" Dense(2F, F)}, "mp": [{"norm" {weight, bias}, "q" Dense(F,
F), "k" Dense(F, F), "v" Dense(F, 3F), "o" Dense(F, 3F), "vec" {kernel
[F, 3F]}, "dk" Dense(R, F), "dv" Dense(R, 3F)}], "out_norm" {weight,
bias}, "fc", "out", "peak_std", "peak_avg"}``. Its ``ModelConfig``
mapping: F ``atom_feature_size``, ``mp_layers`` attention layers, R
``edge_hidden_size`` exponential-normal radial functions,
``edge_feature_size`` the heads (which must divide F), ``rbf_low`` and
``rbf_high`` the lower and upper cutoffs (nm), SiLU as ``mp_activation``
(the filters' and the attention's), the readout as the other families';
``edge_fc_layers`` is unused. Inference only, as PaiNN. Its forward is
one ``nmrgnn.filter`` span (geometry and basis), one ``nmrgnn.embed``
(the neighbor embedding) and one ``nmrgnn.mp`` a layer holding
``nmrgnn.attn`` (every block of the attention stage) and two
``nmrgnn.update`` (the steps before it and after it).

Training mode (``training=True``, ``nmrgnn_tpu/models/gnn.py:144-236``)
adds Gaussian noise of std ``config.noise`` to the distances before the
RBF, the padding mask still taken from the distances before the noise, and
dropout of rate ``config.dropout_rate`` after the FC block. Torch cannot
draw JAX's threefry numbers, so the training forwards take the draws as
tensors: ``noise`` (standard normal, the shape of ``edges``) and
``dropout_mask`` (bool, True = keep, the shape of the FC block's output).
A draw not given is taken from ``generator`` (a ``torch.Generator`` on the
graph's device). peak_std and peak_avg are frozen: no gradient reaches
them (``trainable_mask``).

``config.compute_dtype`` ("float32" or "bfloat16") sets the operand type
of the products, with float32 sums, as in the JAX package: the edge stage,
the MP layers and the FC block, but not the embedding nor, in this gather
forward, the per-element head (``nmrgnn_tpu/models/gnn.py:181-214``).
Under a profiler session each MP layer of ``apply`` is one ``nmrgnn.mp``
span (``utils.profiling.span``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..graph import Graph
from ..ops import attention, edge, et, painn
from ..ops.edge import as_operand
from ..ops.activations import get_activation
from ..ops.message_passing import mp_layer
from ..utils.profiling import span

Params = Dict[str, Any]

# the families that read the atoms' positions beside the graph and serve
# inference only
POSITIONS_FAMILIES = ("painn", "et")


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
    fan_out = E*F; an attention model's wq [F, E], wk [E, E] and wv [F, F]
    take their own two dimensions as fans; a PaiNN or ET model draws its
    own layout (the module's docstring; ET's LayerNorms start at 1 and 0).
    ``peak_standards`` maps element index -> (name, avg, std); peak_std
    defaults to 1 and peak_avg to 0."""
    dev = resolve_device(device)
    F, E, H, V = (config.atom_feature_size, config.edge_feature_size,
                  config.edge_hidden_size, config.num_elements)
    if config.mp_type == "painn":
        family = _painn_params(config, generator)
    elif config.mp_type == "et":
        family = _et_params(config, generator)
    else:
        edge_fc = [_dense_init(generator, H, H) for _ in range(config.edge_fc_layers - 1)]
        edge_fc.append(_dense_init(generator, H, E))
        if config.mp_type == "attention":
            mp = [{"wq": _glorot(generator, (F, E), F, E), "wk": _glorot(generator, (E, E), E, E),
                   "wv": _glorot(generator, (F, F), F, F)} for _ in range(config.mp_layers)]
        else:
            mp = [{"w": _glorot(generator, (F, F, E), F * F, E * F)}
                  for _ in range(config.mp_layers)]
        family = {"edge_fc": edge_fc, "mp": mp}
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
        **family,
        "fc": fc,
        "out": _dense_init(generator, F // 2, V),
        "peak_std": peak_std,
        "peak_avg": peak_avg,
    }
    return tree_map(lambda t: t.to(dev), params)


def _painn_params(config: ModelConfig, generator) -> Params:
    """PaiNN's filter Dense and interaction blocks."""
    F, R, B = config.atom_feature_size, config.edge_hidden_size, config.mp_layers
    filt = _dense_init(generator, R, B * 3 * F)
    blocks = [{"context": [_dense_init(generator, F, F), _dense_init(generator, F, 3 * F)],
               "mix": [_dense_init(generator, 2 * F, F), _dense_init(generator, F, 3 * F)],
               "channel_mix": _dense_init(generator, F, 2 * F, use_bias=False)}
              for _ in range(B)]
    return {"filter": filt, "mp": blocks}


def _et_params(config: ModelConfig, generator) -> Params:
    """ET's neighbor embedding, attention layers and last LayerNorm."""
    F, R, V = config.atom_feature_size, config.edge_hidden_size, config.num_elements
    _heads(config)
    norm = lambda: {"weight": torch.ones((F,), dtype=torch.float32),  # noqa: E731
                    "bias": torch.zeros((F,), dtype=torch.float32)}
    neighbor = {"embed": _dense_init(generator, V, F, use_bias=False),
                "dist": _dense_init(generator, R, F),
                "combine": _dense_init(generator, 2 * F, F)}
    layers = [{"norm": norm(), "q": _dense_init(generator, F, F),
               "k": _dense_init(generator, F, F), "v": _dense_init(generator, F, 3 * F),
               "o": _dense_init(generator, F, 3 * F),
               "vec": _dense_init(generator, F, 3 * F, use_bias=False),
               "dk": _dense_init(generator, R, F), "dv": _dense_init(generator, R, 3 * F)}
              for _ in range(config.mp_layers)]
    return {"neighbor": neighbor, "mp": layers, "out_norm": norm()}


def _heads(config: ModelConfig) -> int:
    """ET's heads (``edge_feature_size``); raises where they do not divide F."""
    heads, F = config.edge_feature_size, config.atom_feature_size
    if heads < 1 or F % heads:
        raise ValueError(f"mp_type='et': {heads} heads (edge_feature_size) do not divide "
                         f"atom_feature_size {F}")
    return heads


def edge_features(params: Params, config: ModelConfig, edges: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """f32[N, K, E]: RBF + EdgeFC, masked by ``edges > 0`` (or by ``mask``,
    f32[N, K, 1]) before and after; the EdgeFC products in the compute
    type."""
    return edge.edge_features(edges, params["edge_fc"], rbf_low=config.rbf_low,
                              rbf_high=config.rbf_high,
                              activation_name=config.fc_activation,
                              compute_dtype=compute_dtype(config), mask=mask)


def readout(params: Params, config: ModelConfig, atoms: torch.Tensor,
            nodes: torch.Tensor, head_dtype=torch.float32,
            dropout_mask=None, dense_fn=dense) -> torch.Tensor:
    """FC block (products in the compute type), dropout where
    ``dropout_mask`` is given (kept values scaled by 1 / keep), per-element
    head (products in ``head_dtype``) and de-standardization by the frozen
    standards -> peaks f32[N]. ``dense_fn``: the dense layer (``apply``'s)."""
    fc_act = get_activation(config.fc_activation)
    cd = compute_dtype(config)
    for p in params["fc"][:-1]:
        nodes = dense_fn(p, nodes, fc_act, cd) + nodes
    nodes = dense_fn(params["fc"][-1], nodes, fc_act, cd)
    if dropout_mask is not None:
        keep = 1.0 - config.dropout_rate
        nodes = torch.where(dropout_mask, nodes / keep, torch.zeros_like(nodes))
    full_peaks = dense_fn(params["out"], nodes, None, head_dtype)
    peak_std, peak_avg = params["peak_std"].detach(), params["peak_avg"].detach()
    return torch.sum(full_peaks * atoms * peak_std + atoms * peak_avg, dim=-1)


def _draw(given, shape, what: str, draw, generator):
    """A training draw: ``given`` (checked against ``shape``), else one
    from ``generator``."""
    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"{what} has shape {tuple(given.shape)}, expected {tuple(shape)}")
        return given
    if generator is None:
        raise ValueError(f"training=True needs {what} or a generator")
    return draw(generator)


def training_draws(config: ModelConfig, edges: torch.Tensor, readout_shape,
                   noise=None, dropout_mask=None, generator=None):
    """(noise or None, dropout_mask or None) of a training forward: the
    given tensors, or draws from ``generator`` on the device of ``edges``
    (standard normal of the shape of ``edges``; keep with probability
    1 - dropout_rate, of ``readout_shape``). None where the config turns
    noise (``noise`` 0) or dropout off."""
    dev = edges.device
    if config.noise > 0:
        noise = _draw(noise, edges.shape, "noise", lambda g: torch.randn(
            tuple(edges.shape), generator=g, device=dev), generator)
    else:
        noise = None
    if config.dropout:
        keep = 1.0 - config.dropout_rate
        dropout_mask = _draw(dropout_mask, readout_shape, "dropout_mask", lambda g: torch.rand(
            tuple(readout_shape), generator=g, device=dev) < keep, generator)
    else:
        dropout_mask = None
    return noise, dropout_mask


def noised(config: ModelConfig, edges: torch.Tensor, noise) -> torch.Tensor:
    """The distances a training forward expands: ``edges`` plus
    ``config.noise`` times the standard-normal ``noise`` (None: ``edges``)."""
    return edges if noise is None else edges + config.noise * noise


def apply(params: Params, config: ModelConfig, graph: Graph, *, positions=None,
          training: bool = False, noise=None, dropout_mask=None, generator=None,
          dense_fn=dense, mp_fn=mp_layer) -> torch.Tensor:
    """Forward for one graph of tensors; peaks f32[N]. The plain gather
    forward: the reference every faster path is held to. ``training=True``
    applies the distance noise and the readout dropout (draws: see the
    module's docstring; ``dropout_mask`` is [N, F // 2]). ``positions``
    (f32[N, 3], nm) is read by a PaiNN or ET model alone, which needs it.

    ``dense_fn`` (``dense``'s signature) and ``mp_fn`` (``mp_layer``'s)
    compute the products of the embedding, FC block and head, and of the
    bilinear MP layers: the plain ones by default, the tensor-parallel
    slices' in ``parallel/sharding.tp_products``."""
    if config.mp_type in POSITIONS_FAMILIES:
        if training:
            raise ValueError(f"mp_type={config.mp_type!r} serves inference only: "
                             "no training forward")
        if positions is None:
            raise ValueError(f"mp_type={config.mp_type!r} needs the atoms' positions: "
                             "apply(params, config, graph, positions=f32[N, 3] nm)")
        fwd = apply_painn if config.mp_type == "painn" else apply_et
        return fwd(params, config, graph, positions, dense_fn)
    atoms, nlist, edges, inv_degree = graph
    mp_act = get_activation(config.mp_activation)
    cd = compute_dtype(config)
    mask = (edges > 0).to(torch.float32)[..., None]
    if training:
        noise, dropout_mask = training_draws(
            config, edges, (edges.shape[0], config.atom_feature_size // 2), noise,
            dropout_mask, generator)
    else:
        noise = dropout_mask = None
    e = edge_features(params, config, noised(config, edges, noise), mask=mask)
    nodes = dense_fn(params["embed"], atoms)
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            if config.mp_type == "attention":
                nodes = attention.amp(p["wq"], p["wk"], p["wv"], nodes, nlist, e, inv_degree,
                                      config.mp_activation)
            else:
                nodes = mp_fn(p["w"], nodes, nlist, e, inv_degree, mp_act, cd) + nodes
    return readout(params, config, atoms, nodes, dropout_mask=dropout_mask, dense_fn=dense_fn)


def apply_painn(params: Params, config: ModelConfig, graph: Graph, positions,
                dense_fn=dense) -> torch.Tensor:
    """PaiNN's forward (``ops/painn.py``) for one graph and its atoms'
    ``positions`` f32[N, 3] nm; peaks f32[N] through ``readout``."""
    atoms, nlist, edges, _ = graph
    act = get_activation(config.mp_activation)
    cd = compute_dtype(config)
    F, cutoff = config.atom_feature_size, config.rbf_high
    with span("nmrgnn.filter"):
        d, unit = painn.edge_geometry(positions, nlist, edges, cutoff)
        w = painn.filters(params["filter"], d, config.edge_hidden_size, cutoff, cd)
    s = dense_fn(params["embed"], atoms)
    v = torch.zeros((s.shape[0], 3, F), dtype=s.dtype, device=s.device)
    for i, p in enumerate(params["mp"]):
        with span("nmrgnn.mp"):
            with span("nmrgnn.message"):
                s, v = painn.message(p, s, v, w[..., 3 * F * i:3 * F * (i + 1)], unit, nlist,
                                     edges, act, dense_fn, cd)
            with span("nmrgnn.update"):
                s, v = painn.update(p, s, v, act, dense_fn, cd)
    return readout(params, config, atoms, s, dense_fn=dense_fn)


def apply_et(params: Params, config: ModelConfig, graph: Graph, positions,
             dense_fn=dense) -> torch.Tensor:
    """ET's forward (``ops/et.py``) for one graph and its atoms'
    ``positions`` f32[N, 3] nm; peaks f32[N] through ``readout``."""
    atoms, nlist, edges, _ = graph
    heads = _heads(config)
    act = get_activation(config.mp_activation)
    cd = compute_dtype(config)
    with span("nmrgnn.filter"):
        geo = et.geometry(positions, nlist, edges, config.edge_hidden_size, config.rbf_low,
                          config.rbf_high)
    x = dense_fn(params["embed"], atoms)
    with span("nmrgnn.embed"):
        x = et.neighbor_embedding(params["neighbor"], x, atoms, geo, dense_fn, cd)
    vec = torch.zeros((x.shape[0], 3, x.shape[1]), dtype=x.dtype, device=x.device)
    for p in params["mp"]:
        with span("nmrgnn.mp"):
            with span("nmrgnn.update"):
                q, k, v, u3, vec_dot = et.update_in(p, x, vec, dense_fn, cd)
            with span("nmrgnn.attn"):
                sx, sv = et.fused_attention(p, q, k, v, vec, geo, heads, act, cd)
            with span("nmrgnn.update"):
                x, vec = et.update_out(p, x, vec, sx, sv, u3, vec_dot, dense_fn, cd)
    x = et.layer_norm(params["out_norm"], x)
    return readout(params, config, atoms, x, dense_fn=dense_fn)


def flatten_batch(graph: Graph) -> Graph:
    """A batch Graph[B, N, ...] as one graph of B * N rows, fragment b's
    neighbor indices moved by b * N (its padding slots too: their distance
    0 masks them)."""
    atoms, nlist, edges, inv_degree = graph
    B, N, _ = nlist.shape
    offs = (torch.arange(B, dtype=nlist.dtype, device=nlist.device) * N)[:, None, None]
    flat = lambda a: a.reshape((B * N,) + tuple(a.shape[2:]))  # noqa: E731
    return Graph(flat(atoms), flat(nlist + offs), flat(edges), flat(inv_degree))


def apply_batched(params: Params, config: ModelConfig, graph: Graph, *,
                  training: bool = False, noise=None, dropout_mask=None,
                  generator=None, **products) -> torch.Tensor:
    """``apply`` over a leading batch axis: Graph[B, N, ...] -> f32[B, N].
    The fragments run as one graph of B * N rows (``flatten_batch``), each
    row's sums as in ``apply``. Draws are per fragment: ``noise``
    [B, N, K], ``dropout_mask`` [B, N, F // 2]. ``products``: ``apply``'s
    ``dense_fn`` / ``mp_fn``."""
    B, N = graph.nlist.shape[:2]
    flat = lambda a: None if a is None else a.reshape((B * N,) + tuple(a.shape[2:]))  # noqa: E731
    if training:
        noise, dropout_mask = training_draws(
            config, graph.edges, (B, N, config.atom_feature_size // 2), noise, dropout_mask,
            generator)
    peaks = apply(params, config, flatten_batch(graph), training=training, noise=flat(noise),
                  dropout_mask=flat(dropout_mask), **products)
    return peaks.view(B, N)


def trainable_mask(params: Params) -> Params:
    """Tree of bools: True for the trainable leaves (not peak_std and
    peak_avg, frozen buffers as in the reference)."""
    return {k: tree_map(lambda _: k not in ("peak_std", "peak_avg"), v)
            for k, v in params.items()}


def tree_leaves(tree) -> list:
    """The tensors of a params tree, dict keys in sorted order and list
    items in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def trainable_leaves(params: Params) -> list:
    """The trainable tensors of a params tree (``tree_leaves`` without
    peak_std and peak_avg): the order the optimizer's state keeps."""
    return tree_leaves({k: v for k, v in params.items() if k not in ("peak_std", "peak_avg")})


def count_params(params: Params) -> int:
    """Trainable parameters (peak_std / peak_avg are frozen buffers)."""
    return sum(int(np.prod(tuple(t.shape))) for t in trainable_leaves(params))
