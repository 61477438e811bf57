"""Fragments of whole structures, and synthetic labels
(``nmrgnn_tpu/data/fragment.py``).

A fragment is the ``fragment_size`` atoms nearest a seed atom, seeds
striding over the structure; its closest ``core_fraction`` weigh 1, the
rest (the halo that completes the core's neighborhoods) 0. Without real
shift labels, ``synthetic_shift`` gives learnable geometry-derived ones:
the element's mean plus a smooth function of the local distances, scaled
by the element's shift std.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .dataset import write_fragment
from .embeddings import element_to_index, load_embeddings, load_standards
from .neighbors import neighbors_host
from .parse import ANGSTROM_TO_NM
from .pdb import Structure
from .tfrecord import TFRecordWriter


def fragment_structure(
    struct: Structure,
    frame: int = 0,
    fragment_size: int = 256,
    neighbor_number: int = 16,
    core_fraction: float = 0.5,
    stride: Optional[int] = None,
    embeddings: Optional[dict] = None,
) -> Iterator[dict]:
    """Fragment dicts {atom_idx, nlist, edges (nm), orig_index, weight}: for
    seeds 0, stride, 2 stride, ... the ``fragment_size`` atoms nearest the
    seed in increasing distance, their k-NN graph, the nearest
    ``core_fraction`` weighted 1."""
    if embeddings is None:
        embeddings = load_embeddings()
    coords = struct.coords[frame]
    n = coords.shape[0]
    size = min(fragment_size, n)
    if stride is None:
        stride = max(1, int(size * core_fraction) // 2)
    elem_idx = np.asarray([element_to_index(e) for e in struct.elements], np.int64)

    from scipy.spatial import cKDTree

    tree = cKDTree(coords)
    for seed in range(0, n, stride):
        _, idx = tree.query(coords[seed], k=size)
        idx = np.atleast_1d(idx)
        nlist, dists = neighbors_host(coords[idx], neighbor_number)
        n_core = max(1, int(len(idx) * core_fraction))
        weight = np.zeros(len(idx), np.float32)
        weight[:n_core] = 1.0  # the query returns ascending distance
        yield {
            "atom_idx": elem_idx[idx],
            "nlist": nlist,
            "edges": (dists * ANGSTROM_TO_NM).astype(np.float32),
            "orig_index": idx,
            "weight": weight,
        }


def synthetic_shift(atom_idx: np.ndarray, edges: np.ndarray, standards=None) -> np.ndarray:
    """Deterministic pseudo-shifts f32[N]: avg + std * 0.5 * (sin(25 mean
    distance) + 0.5 cos(60 nearest distance)) of each atom's element."""
    if standards is None:
        standards = load_standards()
    avg = np.asarray([standards[i][1] for i in range(len(standards))])
    std = np.asarray([standards[i][2] for i in range(len(standards))])
    real = (edges > 0).sum(-1)
    mean_d = np.where(real > 0, edges.sum(-1) / np.maximum(real, 1), 0.0)
    z = np.sin(25.0 * mean_d) + 0.5 * np.cos(60.0 * edges[:, 0])
    return (avg[atom_idx] + std[atom_idx] * 0.5 * z).astype(np.float32)


def name_index_for(struct: Structure, embeddings: Optional[dict] = None) -> np.ndarray:
    """The '<RES>-<ATOMNAME>' vocabulary index of each atom; 0 if unknown."""
    if embeddings is None:
        embeddings = load_embeddings()
    names = embeddings["name"]
    return np.asarray([names.get(f"{rn}-{an}", 0)
                       for rn, an in zip(struct.resnames, struct.names)], np.int64)


def write_structure_records(
    path: str,
    struct: Structure,
    frames: Optional[range] = None,
    shifts: Optional[np.ndarray] = None,  # f32[T, N] labels, NaN = unlabeled
    neighbor_number: int = 16,
    append: bool = False,
) -> int:
    """One record per frame of the WHOLE structure, in the fragment schema
    (the input of whole-structure training). Labels are ``shifts`` or the
    synthetic ones; returns the record count."""
    embeddings = load_embeddings()
    name_idx = name_index_for(struct, embeddings)
    elem_idx = np.asarray([element_to_index(e) for e in struct.elements], np.int64)
    frames = frames if frames is not None else range(struct.n_frames)
    count = 0
    with TFRecordWriter(path, append=append) as w:
        for t in frames:
            nlist, dists = neighbors_host(struct.coords[t], neighbor_number)
            edges = (dists * ANGSTROM_TO_NM).astype(np.float32)
            if shifts is not None:
                shift = np.asarray(shifts[t], np.float32)
                labeled = np.isfinite(shift)
                shift = np.where(labeled, shift, 0.0).astype(np.float32)
            else:
                shift = synthetic_shift(elem_idx, edges)
                labeled = np.ones(len(elem_idx), bool)
            label_weight = ((name_idx > 0) & labeled).astype(np.float32)
            write_fragment(w, elem_idx, nlist, edges, shift, name_idx, label_weight,
                           np.ones(len(elem_idx), np.float32))
            count += 1
    return count


def write_structure_fragments(
    path: str,
    struct: Structure,
    frames: Optional[range] = None,
    shifts: Optional[np.ndarray] = None,  # f32[T, N] labels
    fragment_size: int = 256,
    neighbor_number: int = 16,
) -> int:
    """Fragment a structure (over ``frames``, default all) into a TFRecord
    file; labels are ``shifts`` or the synthetic ones, flagged where the
    atom name is in the vocabulary. Returns the record count."""
    embeddings = load_embeddings()
    name_idx_full = name_index_for(struct, embeddings)
    frames = frames or range(struct.n_frames)
    count = 0
    with TFRecordWriter(path) as w:
        for t in frames:
            for frag in fragment_structure(struct, t, fragment_size, neighbor_number,
                                           embeddings=embeddings):
                idx = frag["orig_index"]
                if shifts is not None:
                    shift = shifts[t][idx].astype(np.float32)
                else:
                    shift = synthetic_shift(frag["atom_idx"], frag["edges"])
                name_idx = name_idx_full[idx]
                write_fragment(w, frag["atom_idx"], frag["nlist"], frag["edges"], shift,
                               name_idx, (name_idx > 0).astype(np.float32), frag["weight"])
                count += 1
    return count
