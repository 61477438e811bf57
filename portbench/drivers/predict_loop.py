"""One caller in a closed loop of ``ServingModel.predict``, as a
chemical-shift-restrained molecular dynamics run calls it: each request
is the structure one time step after the last, and the next request is
sent when the peaks of the last are on the host.

Traffic parameters: ``atoms`` and ``grid`` (shifted copies of one
protein-like structure, ``gap`` Angstrom apart); ``frames`` structures,
each one step of ``time_step_fs`` at ``temperature_K`` from the last
(``reference.structures.thermal_walk``), served forward and back
(0, 1, ..., frames - 1, frames - 2, ..., 1, 0, 1, ...) so that every
request lies one step from the one before; all made from
``structure_seed``: the same requests in the same order whatever the
run's seed, which draws the weights and the requests checked (the order
moves the work through the program's plan cache); ``neighbors`` (K),
``precision``, ``warmup`` requests in set-up, ``compare`` requests
checked against the reference.

The graphs are made in set-up by the benchmark's own k-NN on the device;
the program gets the same graph the reference gets.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import compare, inputs
from ..harness.weights import copy_params, draw_params
from ..reference import model as ref
from ..reference.structures import one_hot, supercell_coords, thermal_walk


class State:
    pass


def setup(cell):
    from nmrgnn_tpu_torch.models.serving import ServingModel

    t = cell.traffic
    st = State()
    st.params = draw_params(cell.config, cell.seed, cell.device)
    cell.mark("weights")
    xyz, elements = supercell_coords(t["atoms"], t["grid"],
                                     np.random.default_rng([t["structure_seed"], 1]), gap=t["gap"])
    atoms = one_hot(elements)
    walk = thermal_walk(xyz, elements, t["frames"], t["temperature_K"], t["time_step_fs"],
                        np.random.default_rng([t["structure_seed"], 2]))
    st.frames = []
    for conf in walk:
        conf = torch.as_tensor(conf.astype(np.float32), device=cell.device)
        st.frames.append(inputs.graph(atoms, *inputs.knn_device(conf, t["neighbors"])))
    cell.mark("graphs")
    st.model = ServingModel(copy_params(st.params), cell.model_config(), device=cell.device,
                            precision=t["precision"])
    for i in range(t["warmup"]):
        st.model.predict(st.frames[frame_of(i, len(st.frames))])
    cell.mark("warmup")
    n = xyz.shape[0]
    edges = int(sum((g[2] > 0).sum() for g in st.frames) / len(st.frames))
    cell.record["work"] = cell.work(n, edges, n * t["neighbors"])
    return st


def frame_of(i: int, frames: int) -> int:
    """The frame of request ``i``: forward through the frames, then back."""
    period = 2 * (frames - 1)
    k = i % period if period else 0
    return k if k < frames else period - k


def _request(st, i):
    with torch.profiler.record_function("portbench.predict"):
        return st.model.predict(st.frames[frame_of(i, len(st.frames))])


def window(cell, st, seconds: float, slice_=None, slice_seconds: float = 0.0) -> None:
    st.out, lat = [], []
    t_start = cell.record["t_window"] = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        peaks = _request(st, i)
        t1 = time.perf_counter()
        if t1 > t_end:
            break
        lat.append(t1 - t0)
        st.out.append((frame_of(i, len(st.frames)), peaks))
        i += 1
    tenth = max(1, len(lat) // 10)
    cell.record.update(window_s=seconds, attempted=i + 1,
                       units={"requests": len(lat), "latencies_s": lat},
                       detail={"first_tenth_ms": 1e3 * float(np.mean(lat[:tenth])) if lat else None,
                               "last_tenth_ms": 1e3 * float(np.mean(lat[-tenth:])) if lat else None})
    if slice_ is not None:
        slice_.begin()
        t_end = time.perf_counter() + slice_seconds
        while time.perf_counter() < t_end:
            _request(st, i)
            slice_.units += 1
            i += 1
        slice_.end()


def release(st) -> None:
    st.model = None


def _sample(cell, st):
    k = min(cell.traffic["compare"], len(st.out))
    pick = cell.rng(3).choice(len(st.out), size=k, replace=False)
    return [st.out[j] for j in sorted(pick)]


def check(cell, st, control: bool = False) -> dict:
    """{"peak_gap"} of the served requests (``control``: of the reference
    in TF32 in the program's place) on a sample drawn from the seed."""
    if not st.out:
        return {"peak_gap": float("inf")}
    gaps = []
    for j, served in _sample(cell, st):
        g = [torch.as_tensor(np.asarray(a), device=cell.device) for a in st.frames[j]]
        with torch.no_grad():
            want = ref.forward(st.params, cell.config, *g).cpu().numpy()
            if control:
                served = ref.forward(st.params, cell.config, *g,
                                     prod=ref.Products(tf32=True)).cpu().numpy()
        gaps.append(compare.peak_gap(served, want))
    return {"peak_gap": max(gaps)}
