"""Graph tuple and padding, as ``nmrgnn_tpu/graph.py``.

    atoms      f32[N, V]   one-hot element identity
    nlist      i32[N, K]   neighbor indices
    edges      f32[N, K]   neighbor distances, in nm
    inv_degree f32[N]      1 / (number of neighbor slots with nlist > 0)

The fields hold numpy arrays on the host side of the pipeline and torch
tensors once moved to a device. Padding conventions: a slot with distance
0 is masked out of edge features, a slot with index 0 does not count
toward the degree, and degree 0 gives inv_degree 0.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Graph(NamedTuple):
    atoms: object       # f32[N, V]
    nlist: object       # i32[N, K]
    edges: object       # f32[N, K]
    inv_degree: object  # f32[N]

    @property
    def num_atoms(self) -> int:
        return self.atoms.shape[-2]

    @property
    def num_neighbors(self) -> int:
        return self.nlist.shape[-1]

    @property
    def num_elements(self) -> int:
        return self.atoms.shape[-1]


def inv_degree_from_nlist(nlist) -> np.ndarray:
    """1/degree, where degree counts slots with ``nlist > 0`` and degree 0
    gives 0."""
    deg = np.sum(np.asarray(nlist) > 0, axis=-1).astype(np.float32)
    return np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0).astype(np.float32)


def pad_graph(g: Graph, pad_to: int) -> Graph:
    """Pad one numpy-backed graph with inert atoms up to ``pad_to`` rows:
    zero one-hot rows, nlist 0, edges 0, inv_degree 0."""
    n = g.atoms.shape[0]
    if n > pad_to:
        raise ValueError(f"graph has {n} atoms > pad_to={pad_to}")
    p = pad_to - n
    return Graph(
        atoms=np.pad(np.asarray(g.atoms), ((0, p), (0, 0))),
        nlist=np.pad(np.asarray(g.nlist), ((0, p), (0, 0))),
        edges=np.pad(np.asarray(g.edges), ((0, p), (0, 0))),
        inv_degree=np.pad(np.asarray(g.inv_degree), ((0, p),)),
    )


def pad_graph_np(atoms, nlist, edges, inv_degree, pad_to: int):
    """``pad_graph`` on the four arrays, returned as a tuple."""
    return tuple(pad_graph(Graph(atoms, nlist, edges, inv_degree), pad_to))


def atom_mask(g: Graph):
    """f32[..., N]: 1 for real atoms (a nonzero one-hot row), 0 for padding;
    a tensor for a tensor graph, else a numpy array."""
    if isinstance(g.atoms, torch.Tensor):
        return (g.atoms.sum(-1) > 0).to(torch.float32)
    return (np.sum(np.asarray(g.atoms), axis=-1) > 0).astype(np.float32)


def bucket_size(
    n: int,
    buckets=(256, 512, 768, 1024, 1536, 2048, 2560, 3072, 4096, 6144, 8192,
             12288, 16384),
) -> int:
    """Smallest bucket >= n; beyond the largest, the next multiple of 1024."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


def ring_graph(
    n: int = 5,
    k: int = 2,
    num_elements: int = 16,
    edge_value: float = 1.0,
    elements: Optional[list] = None,
) -> Graph:
    """The reference's 5-node ring test fixture (numpy arrays): node i's
    neighbors are (i - 1, i + 1, i + 3, ...) mod n in its k slots, every
    distance ``edge_value``, inv_degree 1 / k; element (3 i + 2) mod
    ``num_elements`` unless ``elements`` is given."""
    if elements is None:
        elements = [(3 * i + 2) % num_elements for i in range(n)]
    atoms = np.zeros((n, num_elements), dtype=np.float32)
    atoms[np.arange(n), np.asarray(elements) % num_elements] = 1.0
    nlist = ((np.arange(n)[:, None] + np.arange(-1, 2 * k - 1, 2)[None, :]) % n).astype(np.int32)
    edges = np.full((n, k), edge_value, dtype=np.float32)
    inv_degree = np.full((n,), 1.0 / k, dtype=np.float32)
    return Graph(atoms, nlist, edges, inv_degree)
