"""The predict loop of ``predict_loop_xyz.py`` for MACE (``mp_type="mace"``):
one caller in a closed loop of ``ServingModel.predict(graph, positions=)``,
each request the structure one time step after the last, the next sent
when the last one's peaks are on the host.

The traffic parameters, the structure, the cutoff graphs, the frames
with their positions and the loop are ``predict_loop_xyz``'s; the weights
are ``harness/weights_mace.py``'s draw and the check compares with
``reference/mace.py``. ``detail`` adds the real edges a request (the
frames' mean), the rows of a convolution block and the blocks a layer,
and the symmetric contraction's paths eta for each order nu and output L.
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness import compare, inputs
from ..harness.weights import copy_params
from ..harness.weights_mace import draw_params
from ..reference import mace as ref
from ..reference.model import Products
from ..reference.structures import ANGSTROM_TO_NM, one_hot, thermal_walk
from . import predict_loop_xyz as xyz
from .predict_loop_xyz import (  # noqa: F401 (the loop's own)
    Frame, PositionsBeside, State, _sample, cutoff_graph, frame_of, release, supercell)


def setup(cell):
    from nmrgnn_tpu_torch.models.serving import ServingModel
    from nmrgnn_tpu_torch.ops import mace

    t = cell.traffic
    st = State()
    st.params = draw_params(cell.config, cell.seed, cell.device)
    cell.mark("weights")
    xyz_a, elements = supercell(t)
    atoms = one_hot(elements)
    walk = thermal_walk(xyz_a, elements, t["frames"], t["temperature_K"], t["time_step_fs"],
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
    n = xyz_a.shape[0]
    edges = int(sum((g[2] > 0).sum() for g in st.frames) / len(st.frames))
    st.detail = {"real_edges": edges, "block_rows": mace.BLOCK_ROWS,
                 "blocks_a_layer": -(-n // mace.BLOCK_ROWS),
                 "eta": {f"nu{nu}_L{L}": ref.u_basis(nu, L).shape[-1] for nu in (1, 2, 3)
                         for L in range(cell.config["edge_feature_size"] + 1)}}
    cell.record["work"] = cell.work(n, edges, n * t["neighbors"])
    return st


def window(cell, st, seconds: float, slice_=None, slice_seconds: float = 0.0) -> None:
    """``predict_loop``'s window; then the request's edges into ``detail``."""
    xyz.window(cell, st, seconds, slice_, slice_seconds)
    cell.record["detail"].update(st.detail)


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
