"""Atom-partitioned forward, all-gather form (``nmrgnn_tpu/parallel/
partition.py``).

One structure is split by atom rows over the ranks of the mesh's
``graph`` axis. Every per-atom operation (RBF, EdgeFC, embedding, FC,
readout) is row-local; only the message-passing gather needs other
shards' rows. This first form gathers the whole node table every MP layer
(``all_gather_into_tensor``); ``parallel/halo.py`` moves only the
boundary rows and runs the kernels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as nnf

from ..config import ModelConfig
from ..graph import Graph
from ..models.gnn import compute_dtype, dense
from ..ops.activations import get_activation
from ..ops.message_passing import mp_aggregate
from .halo import _edge_stage, _graph_group, _own, _shard_readout, all_gather_rows
from .mesh import Mesh


def pad_to_multiple(graph: Graph, m: int) -> Graph:
    """The graph with its atom count padded up to a multiple of ``m`` by
    inert rows (zero atoms, neighbor 0 at distance 0, inv_degree 0);
    numpy arrays or tensors, as given."""
    n = graph.atoms.shape[0]
    p = (-n) % m
    if p == 0:
        return graph
    if isinstance(graph.atoms, torch.Tensor):
        return Graph(nnf.pad(graph.atoms, (0, 0, 0, p)), nnf.pad(graph.nlist, (0, 0, 0, p)),
                     nnf.pad(graph.edges, (0, 0, 0, p)), nnf.pad(graph.inv_degree, (0, p)))
    return Graph(np.pad(graph.atoms, ((0, p), (0, 0))), np.pad(graph.nlist, ((0, p), (0, 0))),
                 np.pad(graph.edges, ((0, p), (0, 0))), np.pad(graph.inv_degree, ((0, p),)))


def apply_partitioned(
    params,
    config: ModelConfig,
    graph: Graph,
    mesh: Mesh,
    axis: str = "graph",
) -> torch.Tensor:
    """Inference forward over an atom-sharded graph; peaks f32[N] of the
    whole structure on every rank.

    ``graph`` is the whole structure (host arrays or tensors) with an atom
    count that is a multiple of the axis size (``pad_to_multiple``); this
    rank runs rows [s m, (s + 1) m) of it, s its position on ``axis``, on
    the device of ``params``. Each MP layer all-gathers the node table and
    aggregates its rows as ``gnn.apply`` does (the bilinear family)."""
    D = mesh.shape[axis]
    n = graph.atoms.shape[0]
    if n % D:
        raise ValueError(f"atom count {n} not divisible by {axis}={D}")
    group = _graph_group(mesh, axis, D)
    m = n // D
    dev = params["embed"]["kernel"].device
    atoms, nlist, edges, inv = _own(graph, dist.get_rank(group), m, dev)
    mp_act = get_activation(config.mp_activation)
    e = _edge_stage(params, config, edges)
    nodes = dense(params["embed"], atoms)
    for p in params["mp"]:
        full = all_gather_rows(nodes, group)  # [N, F]
        nodes = mp_act(mp_aggregate(full, nlist, e, inv, p["w"], compute_dtype(config))) + nodes
    return all_gather_rows(_shard_readout(params, config, atoms, nodes), group)


def jit_partitioned_forward(params, config: ModelConfig, mesh: Mesh, n_atoms: int):
    """The partitioned forward as a callable ``f(params, graph)`` for graphs
    of ``n_atoms`` atoms (the JAX package's jitted form; PyTorch runs it
    eagerly, so nothing is compiled)."""
    if n_atoms % mesh.shape["graph"]:
        raise ValueError(f"atom count {n_atoms} not divisible by graph={mesh.shape['graph']}")

    def f(p, g):
        return apply_partitioned(p, config, g, mesh)

    return f
