"""Protein-like test structures, made from a seed (frozen copies of the
generators in the repository's ``chip_smoke.py``, so that later edits there
do not move the benchmark).

``synthetic_coords`` lays atoms on a jittered cubic lattice cut to a
sphere, in a boustrophedon walk so that atoms adjacent in the list are
adjacent in space, with elements drawn in the proportions of a
hydrogenated protein. ``supercell_coords`` places shifted copies of one
such structure on a grid, a gap apart: an oligomer of separate chains.
"""
from __future__ import annotations

import numpy as np

ANGSTROM_TO_NM = 0.1
BOLTZMANN = 1.380649e-23      # J/K
DALTON = 1.66053906660e-27    # kg

# Standard atomic weights (Da) of the elements the structures hold.
MASSES = {"H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "S": 32.06}

# The model's element vocabulary, in its one-hot order: "X" is padding,
# "Z" any other element (the published nmrgnn embeddings' order).
ELEMENTS = ("X", "Z", "C", "N", "H", "O", "S", "P", "F", "CL")

# Element mix of a hydrogenated protein (fractions of all atoms).
PROTEIN_ELEMENTS = (("H", 0.497), ("C", 0.32), ("N", 0.085), ("O", 0.095), ("S", 0.003))


def synthetic_coords(n_atoms: int, rng: np.random.Generator, spacing: float = 1.4):
    """(coords f64[n, 3] in Angstrom, elements [n] str) of a protein-like
    structure: a cubic lattice of ``spacing`` Angstrom, each point jittered
    by 0.15 A, cut to the ``n_atoms`` points nearest its center."""
    m = int(np.ceil((3 * n_atoms / (4 * np.pi)) ** (1 / 3) * 1.2)) + 1
    ax = np.arange(-m, m + 1)
    walk = []
    for iz, z in enumerate(ax):
        ys = ax if iz % 2 == 0 else ax[::-1]
        for iy, y in enumerate(ys):
            xs = ax if iy % 2 == 0 else ax[::-1]
            walk.extend((x, y, z) for x in xs)
    pts = np.asarray(walk, np.float64) * spacing
    pts += rng.normal(scale=0.15, size=pts.shape)
    keep = np.sort(np.argsort(np.linalg.norm(pts, axis=1), kind="stable")[:n_atoms])
    names, probs = zip(*PROTEIN_ELEMENTS)
    elements = rng.choice(names, size=n_atoms, p=np.asarray(probs) / sum(probs))
    return pts[keep], [str(e) for e in elements]


def supercell_coords(n_atoms: int, grid, rng: np.random.Generator, gap: float = 8.0):
    """(coords, elements) of ``prod(grid)`` shifted copies of one
    ``synthetic_coords`` structure, each its own bounding span plus
    ``gap`` Angstrom from the next."""
    coords, elements = synthetic_coords(n_atoms, rng)
    step = coords.max(axis=0) - coords.min(axis=0) + gap
    shifts = [np.array(c) * step for c in np.ndindex(*grid)]
    return (np.concatenate([coords + s for s in shifts]),
            elements * len(shifts))


def thermal_walk(coords: np.ndarray, elements, frames: int, temperature: float,
                 time_step_fs: float, rng: np.random.Generator) -> np.ndarray:
    """f64[frames, n, 3]: ``coords`` then each frame the last moved, every
    coordinate of each atom by a Gaussian of its thermal speed at
    ``temperature`` K times one time step (sqrt(kT / m) dt), so that
    successive frames lie one molecular-dynamics step apart."""
    mass = np.asarray([MASSES[e] for e in elements]) * DALTON
    step = np.sqrt(BOLTZMANN * temperature / mass) * time_step_fs * 1e-15 * 1e10  # Angstrom
    out = np.empty((frames,) + coords.shape)
    out[0] = coords
    for f in range(1, frames):
        out[f] = out[f - 1] + rng.normal(size=coords.shape) * step[:, None]
    return out


def one_hot(elements) -> np.ndarray:
    """f32[n, len(ELEMENTS)]: each atom's element in the vocabulary."""
    index = {e: i for i, e in enumerate(ELEMENTS)}
    idx = np.asarray([index.get(e, 1) for e in elements], np.int64)
    out = np.zeros((len(idx), len(ELEMENTS)), np.float32)
    out[np.arange(len(idx)), idx] = 1.0
    return out


def inv_degree(nlist: np.ndarray) -> np.ndarray:
    """f32 1 / (slots whose index is above 0), 0 for none: the model's
    padding convention, under which a slot naming atom 0 does not count."""
    deg = (np.asarray(nlist) > 0).sum(-1).astype(np.float32)
    return np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0).astype(np.float32)
