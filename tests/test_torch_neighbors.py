"""The port's host k-NN against the JAX package's (fault C4 of ROADMAP.md):
both take the native cell list when its library builds, so they give the
same neighbor lists, tied neighbors in the same slots and distances to the
bit, and so the same graphs from a structure.

On coordinates with exact ties (a cubic lattice) and on random ones, the
port's own loader (``nmrgnn_tpu_torch/native.py``) and the JAX package's
(``nmrgnn_tpu/native.py``) must both be available here.
"""
import os

import numpy as np
import pytest

from nmrgnn_tpu import native as jnative
from nmrgnn_tpu.data import neighbors as jneighbors
from nmrgnn_tpu.data.parse import structure2graph as jstructure2graph
from nmrgnn_tpu_torch import native
from nmrgnn_tpu_torch.data import neighbors
from nmrgnn_tpu_torch.data.parse import structure2graph


def lattice(m: int, spacing: float = 1.5) -> np.ndarray:
    """f32[m^3, 3]: a cubic lattice, every atom with ties at each shell."""
    ax = np.arange(m, dtype=np.float32) * np.float32(spacing)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)


def coords_of(kind: str) -> np.ndarray:
    if kind == "lattice":
        return lattice(9)
    rng = np.random.default_rng(3)
    return rng.uniform(0.0, 30.0, (2000, 3)).astype(np.float32)


def test_native_library_builds_and_loads_outside_native():
    assert native.available()
    assert native.library_path().startswith(native.BUILD_DIR)
    assert os.path.exists(native.library_path())
    assert jnative.available()


@pytest.mark.parametrize("kind,k", [("lattice", 16), ("lattice", 26), ("random", 16)])
def test_neighbors_host_matches_jax(kind, k):
    coords = coords_of(kind)
    got_i, got_d = neighbors.neighbors_host(coords, k)
    want_i, want_d = jneighbors.neighbors_host(coords, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    # the native path was taken: scipy orders the lattice's ties otherwise
    nat_i, nat_d = native.cell_list_knn(coords, k)
    np.testing.assert_array_equal(got_i, nat_i)
    np.testing.assert_array_equal(got_d, nat_d)
    if kind == "lattice":
        sp_i, _ = neighbors.neighbors_host(coords, k, use_native=False)
        assert (sp_i != nat_i).any(), "the lattice has no tie that the two searches order apart"


def test_structure2graph_matches_jax_on_a_lattice(tmp_path):
    """A PDB of a cubic lattice (exact ties at every shell): the port's
    graph equals the JAX package's array for array."""
    coords = lattice(8)
    path = str(tmp_path / "lattice.pdb")
    lines = ["MODEL        1"]
    for i, (x, y, z) in enumerate(coords):
        el = "CHNO"[i % 4]
        lines.append(f"ATOM  {i + 1:5d}  {el:<3s} ALA A{i // 10 + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {el:>2s}")
    lines += ["ENDMDL", "END"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    got, want = structure2graph(path), jstructure2graph(path)
    for name in ("atoms", "nlist", "edges", "inv_degree"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
