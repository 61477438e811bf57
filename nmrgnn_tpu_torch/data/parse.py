"""Structure -> graph conversion (``nmrgnn_tpu/data/parse.py``).

  * atoms: one-hot over the canonical 10-element vocabulary
  * edges: k-NN distances in nm (PDB Angstrom / 10)
  * nlist: neighbor indices sorted by increasing distance
  * inv_degree: 1 / count(nlist > 0), 0 for isolated atoms
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..graph import Graph, inv_degree_from_nlist
from .embeddings import ELEMENTS, element_to_index, load_embeddings
from .neighbors import neighbors_host
from .pdb import Structure, read_structure

ANGSTROM_TO_NM = 0.1


def atoms_one_hot(elements, num_elements: int = len(ELEMENTS)) -> np.ndarray:
    idx = np.asarray([element_to_index(e) for e in elements], np.int32)
    out = np.zeros((len(idx), num_elements), np.float32)
    out[np.arange(len(idx)), idx] = 1.0
    return out


def inv_degree_np(nlist: np.ndarray) -> np.ndarray:
    """f32 1 / count(nlist > 0) over the last axis, 0 for isolated atoms
    (``nmrgnn_tpu/data/parse.py:34``)."""
    return inv_degree_from_nlist(nlist)


def parse_structure(
    struct: Structure, neighbor_number: int = 16, frame: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(atoms one-hot, edges nm, nlist) for one frame."""
    atoms = atoms_one_hot(struct.elements, len(load_embeddings()["atom"]))
    nlist, dists = neighbors_host(struct.coords[frame], neighbor_number)
    edges = (dists * ANGSTROM_TO_NM).astype(np.float32)
    return atoms, edges, nlist


def structure2graph(
    struct_or_path,
    neighbor_number: int = 16,
    frame: int = 0,
) -> Graph:
    """File path or Structure -> numpy-backed Graph for one frame."""
    struct = (
        struct_or_path
        if isinstance(struct_or_path, Structure)
        else read_structure(struct_or_path)
    )
    atoms, edges, nlist = parse_structure(struct, neighbor_number, frame=frame)
    return Graph(
        atoms=atoms,
        nlist=nlist.astype(np.int32),
        edges=edges,
        inv_degree=inv_degree_from_nlist(nlist),
    )
