"""The predict loop of ``predict_loop.py`` for a model that also reads the
atoms' positions (the PaiNN family): one caller in a closed loop of
``ServingModel.predict(graph, positions=)``, each request the structure
one time step after the last, the next sent when the last one's peaks are
on the host.

Traffic parameters, as ``predict_loop``'s, and: ``spacing`` (Angstrom,
the lattice of ``reference.structures.synthetic_coords``; 2.05 is protein
density) and ``cutoff`` (Angstrom). Each frame's graph comes from the
benchmark's k-NN on the device at ``neighbors`` (K) slots; every slot at
or beyond ``cutoff`` is padding (index 0, distance 0), and set-up fails
if an atom of any frame has all K slots inside it (the cap would drop a
neighbor). The positions, in nm, go beside each graph. The weights are
``harness/weights_painn.py``'s draw; the check compares with
``reference/painn.py``. The window and the release are ``predict_loop``'s,
run on the model as ``PositionsBeside`` wraps it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import compare, inputs
from ..harness.weights import copy_params
from ..harness.weights_painn import draw_params
from ..reference import painn as ref
from ..reference.model import Products
from ..reference.structures import ANGSTROM_TO_NM, one_hot, synthetic_coords, thermal_walk
from .predict_loop import _sample, frame_of, release, window  # noqa: F401 (the loop's own)


class State:
    pass


class Frame(tuple):
    """One request: the graph's four arrays, with the atoms' ``positions``
    f32[N, 3] nm beside them."""

    def __new__(cls, graph, positions):
        frame = super().__new__(cls, graph)
        frame.positions = positions
        return frame


class PositionsBeside:
    """The model as ``predict_loop.window`` calls it, ``predict(frame)``:
    the frame's positions go beside its graph."""

    def __init__(self, model):
        self.model = model

    def predict(self, frame):
        return self.model.predict(frame, positions=frame.positions)


def supercell(t: dict):
    """(coords f64[n, 3] Angstrom, elements) of ``prod(grid)`` shifted copies
    of one ``synthetic_coords`` structure at ``spacing``, each its own
    bounding span plus ``gap`` apart (``structures.supercell_coords`` at
    another lattice)."""
    rng = np.random.default_rng([t["structure_seed"], 1])
    coords, elements = synthetic_coords(t["atoms"], rng, spacing=t["spacing"])
    step = coords.max(axis=0) - coords.min(axis=0) + t["gap"]
    shifts = [np.array(c) * step for c in np.ndindex(*t["grid"])]
    return np.concatenate([coords + s for s in shifts]), elements * len(shifts)


def cutoff_graph(conf: torch.Tensor, k: int, cutoff: float):
    """(nlist, dists Angstrom) of ``inputs.knn_device`` with the slots at or
    beyond ``cutoff`` made padding; raises where an atom has all ``k``
    slots inside it."""
    nlist, dists = inputs.knn_device(conf, k)
    far = dists >= cutoff
    full = int((~far).all(1).sum())
    if full:
        raise ValueError(f"{full} atoms have all {k} slots within {cutoff} A: the cap drops "
                         f"neighbors; raise the traffic's neighbors")
    return nlist.masked_fill(far, 0), dists.masked_fill(far, 0.0)


def setup(cell):
    from nmrgnn_tpu_torch.models.serving import ServingModel

    t = cell.traffic
    st = State()
    st.params = draw_params(cell.config, cell.seed, cell.device)
    cell.mark("weights")
    xyz, elements = supercell(t)
    atoms = one_hot(elements)
    walk = thermal_walk(xyz, elements, t["frames"], t["temperature_K"], t["time_step_fs"],
                        np.random.default_rng([t["structure_seed"], 2]))
    st.frames = []
    for conf in walk:
        conf = torch.as_tensor(conf.astype(np.float32), device=cell.device)
        graph = inputs.graph(atoms, *cutoff_graph(conf, t["neighbors"], t["cutoff"]))
        st.frames.append(Frame(graph, (conf * ANGSTROM_TO_NM).cpu().numpy()))
    cell.mark("graphs")
    st.model = PositionsBeside(ServingModel(copy_params(st.params), cell.model_config(),
                                            device=cell.device, precision=t["precision"]))
    for i in range(t["warmup"]):
        st.model.predict(st.frames[frame_of(i, len(st.frames))])
    cell.mark("warmup")
    n = xyz.shape[0]
    edges = int(sum((g[2] > 0).sum() for g in st.frames) / len(st.frames))
    cell.record["work"] = cell.work(n, edges, n * t["neighbors"])
    return st


def check(cell, st, control: bool = False) -> dict:
    """{"peak_gap"} of the served requests (``control``: of the reference
    in TF32 in the program's place) on a sample drawn from the seed."""
    if not st.out:
        return {"peak_gap": float("inf")}
    gaps = []
    for j, served in _sample(cell, st):
        g = [torch.as_tensor(np.asarray(a), device=cell.device) for a in st.frames[j]]
        pos = torch.as_tensor(st.frames[j].positions, device=cell.device)
        with torch.no_grad():
            want = ref.forward(st.params, cell.config, *g[:3], pos).cpu().numpy()
            if control:
                served = ref.forward(st.params, cell.config, *g[:3], pos,
                                     prod=Products(tf32=True)).cpu().numpy()
        gaps.append(compare.peak_gap(served, want))
    return {"peak_gap": max(gaps)}
