"""Synthetic organic small molecules (``nmrgnn_tpu/data/organic.py``):
randomly branched alkane-like skeletons (C with occasional N and O) with
explicit hydrogens and geometry-derived shifts, written as TFRecord
fragments with MB-* / DFT-* name labels, so that protein + organic
training and the Mol-* metrics run end to end without the proprietary
shift databases. numpy throughout: the same seed gives the JAX package's
molecules and records.
"""
from __future__ import annotations

import numpy as np

from .dataset import write_fragment
from .embeddings import ELEMENT_INDEX, load_embeddings, load_standards
from .fragment import synthetic_shift
from .neighbors import neighbors_host
from .parse import ANGSTROM_TO_NM
from .tfrecord import TFRecordWriter

_CC = 1.52  # Angstrom
_CH = 1.09
_CN = 1.47
_CO = 1.43


def random_molecule(rng: np.random.Generator, max_heavy: int = 16):
    """(coords f32[N, 3] in Angstrom, element_idx i64[N]) of a random
    branched heavy-atom skeleton (C with occasional N or O) with explicit
    hydrogens. The geometry is approximate (random directions, the best of
    40 placements by clearance, crowded parents closed), enough for
    learnable distance features."""
    n_heavy = int(rng.integers(3, max_heavy + 1))
    coords = [np.zeros(3)]
    elems = ["C"]
    parents = [0]
    open_valence = {0: 4}

    def rand_dir():
        v = rng.normal(size=3)
        return v / np.linalg.norm(v)

    def place(parent: int, length: float, tries: int = 40):
        """Best-of-N placement: maximize clearance to all existing atoms."""
        arr = np.asarray(coords)
        best_pos, best_clear = None, -1.0
        for _ in range(tries):
            pos = coords[parent] + rand_dir() * length
            clear = float(np.min(np.linalg.norm(arr - pos, axis=1)))
            if clear > best_clear:
                best_pos, best_clear = pos, clear
        return best_pos, best_clear

    while len([e for e in elems if e != "H"]) < n_heavy:
        candidates = [i for i, v in open_valence.items() if v > 0]
        if not candidates:
            break
        parent = int(rng.choice(candidates))
        elem = rng.choice(["C", "C", "C", "N", "O"])
        length = {"C": _CC, "N": _CN, "O": _CO}[elem]
        pos, clear = place(parent, length)
        if clear < 1.0:
            # too crowded around this parent: close its valence and retry
            open_valence[parent] = 0
            continue
        coords.append(pos)
        elems.append(elem)
        idx = len(coords) - 1
        open_valence[parent] -= 1
        open_valence[idx] = {"C": 3, "N": 2, "O": 1}[elem]

    # hydrogens fill remaining valence (skip when too crowded)
    for i, v in list(open_valence.items()):
        for _ in range(v):
            pos, clear = place(i, _CH)
            if clear < 0.9:
                continue
            coords.append(pos)
            elems.append("H")

    coords = np.asarray(coords, np.float32)
    elem_idx = np.asarray([ELEMENT_INDEX[e] for e in elems], np.int64)
    return coords, elem_idx


def write_organic_fragments(
    path: str,
    n_molecules: int = 100,
    neighbor_number: int = 16,
    seed: int = 0,
    classes=("MB", "DFT"),
    append: bool = False,
) -> int:
    """Write ``n_molecules`` synthetic organic molecules, one record each,
    with the MB or DFT name labels of one class per molecule drawn from
    ``classes``, to the TFRecord ``path`` (appended with ``append``).
    Returns the record count."""
    emb = load_embeddings()
    names = emb["name"]
    rng = np.random.default_rng(seed)
    rev_elem = {v: k for k, v in ELEMENT_INDEX.items()}
    standards = load_standards()
    count = 0
    with TFRecordWriter(path, append=append) as w:
        for _ in range(n_molecules):
            coords, elem_idx = random_molecule(rng)
            n = coords.shape[0]
            nlist, dists = neighbors_host(coords, neighbor_number)
            edges = (dists * ANGSTROM_TO_NM).astype(np.float32)
            cls = classes[int(rng.integers(len(classes)))]
            name_idx = np.asarray(
                [names.get(f"{cls}-{rev_elem[int(e)]}", 0) for e in elem_idx],
                np.int64,
            )
            shift = synthetic_shift(elem_idx, edges, standards)
            label_weight = (name_idx > 0).astype(np.float32)
            weight = np.ones(n, np.float32)
            write_fragment(
                w, elem_idx, nlist, edges, shift, name_idx, label_weight, weight
            )
            count += 1
    return count
