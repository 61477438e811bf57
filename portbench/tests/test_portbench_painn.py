"""The ``painn`` configuration's benchmark files on the CPU: its weights'
draw, its reference (``reference/painn.py``) against the port's forward,
its least work (``flops/painn.py``) against a hand count, the cutoff
graph of ``predict_loop_xyz``, what decides ``correct`` for its cell,
and what its files import. The cell itself rehearses through
``test_portbench_cells.py`` by its tiny size."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control
from portbench.drivers import predict_loop_xyz as xyz_loop
from portbench.harness import inputs
from portbench.harness.cell import Cell, load_json, load_module
from portbench.harness.weights import copy_params, count_params
from portbench.harness.weights_painn import draw_params
from portbench.reference import painn as ref
from portbench.reference.model import Products
from portbench.reference.structures import one_hot
from portbench.run import BENCH, ROOT
from portbench.tests.tiny import SEED, bench, rehearse, tiny_size

CFG = load_json(BENCH, "configs", "painn.json")
CELL = "painn-predict-44676"


def _structure(atoms=120, k=80):
    """(graph tensors, positions nm) of one small chain at the traffic's
    lattice and cutoff."""
    t = {**load_json(BENCH, "traffic", "predict-44676-r5.json"), "atoms": atoms, "grid": [1, 1, 1]}
    xyz, elements = xyz_loop.supercell(t)
    conf = torch.as_tensor(xyz.astype(np.float32))
    nlist, dists = xyz_loop.cutoff_graph(conf, min(k, atoms - 1), t["cutoff"])
    g = inputs.graph(one_hot(elements), nlist, dists)
    return [torch.as_tensor(a) for a in g], conf * 0.1


def _model_config():
    return Cell(name=CELL, root=BENCH, config=CFG, traffic={}, seed=0,
                device=torch.device("cpu")).model_config()


def test_weights_have_the_published_parameter_count_and_the_ports_layout():
    from nmrgnn_tpu_torch.models import gnn

    params = draw_params(CFG, 3, "cpu")
    assert count_params(params) == CFG["parameters"] == 578_122
    port = gnn.init_params(_model_config(), torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: [tuple(t.shape) for t in gnn.tree_leaves(tree)]  # noqa: E731
    assert shapes(params) == shapes(port)


def test_reference_equals_the_ports_forward():
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn

    g, pos = _structure()
    assert (g[2] == 0).any()  # slots past the cutoff are padding
    params = draw_params(CFG, 2 ** 31 + 7, "cpu")
    got = gnn.apply(copy_params(params), _model_config(), Graph(*g), positions=pos).numpy()
    want = ref.forward(params, CFG, *g[:3], pos).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    tf32 = ref.forward(params, CFG, *g[:3], pos, prod=Products(tf32=True)).numpy()
    assert np.max(np.abs(tf32 - want)) > 1e-6 * np.max(np.abs(want))


def test_reference_blocks_do_not_change_the_peaks():
    g, pos = _structure()
    params = draw_params(CFG, 5, "cpu")
    whole = ref.forward(params, CFG, *g[:3], pos)
    assert torch.allclose(ref.forward(params, CFG, *g[:3], pos, block=7), whole, rtol=0, atol=0)


def test_least_work_by_hand():
    mod = load_module(os.path.join(BENCH, "flops", "painn.py"), "flops_painn")
    n, e = 10, 300
    w = mod.work(CFG, n, e)
    F, R, V, D = 128, 20, 10, 3 * 3 * 128
    assert w["filter"][0] == e * (2 * R * D + D)
    assert w["message"][0] == 3 * (n * (2 * F * F + 2 * F * 3 * F) + e * 16 * F)
    assert w["update"][0] == 3 * n * (2 * 3 * F * 2 * F + 2 * 2 * F * F + 2 * F * 3 * F + 16 * F)
    assert w["readout"][0] == n * (2 * F * F // 2 + 2 * F // 2 * V)
    assert w["mp"][0] == w["message"][0] + w["update"][0]
    assert w["forward"] == w["filter"][0] + w["mp"][0] + w["readout"][0]
    # bytes: each input read once, each output written once, float32
    assert w["filter"][1] == 4 * (3 * n + e + R * D + D + e * (D + 3))
    assert w["update"][1] == 3 * 4 * (2 * n * 4 * F + 2 * F * F + F + 3 * F * F + 3 * F
                                      + 2 * F * F)
    # the cell's size: about 198 GFLOP a forward, the filter 116 of it
    full = mod.work(CFG, 44676, 2_451_000)
    assert full["forward"] == pytest.approx(197.77e9, rel=1e-3)
    assert full["filter"][0] == pytest.approx(115.77e9, rel=1e-3)


def test_the_cutoff_graph_pads_far_slots_and_refuses_a_full_row():
    g, _ = _structure()
    real = g[2] > 0
    assert (g[2][real] < 0.5).all() and (g[1][~real] == 0).all()
    t = load_json(BENCH, "traffic", "predict-44676-r5.json")
    conf = torch.as_tensor(xyz_loop.supercell({**t, "atoms": 200, "grid": [1, 1, 1]})[0]
                           .astype(np.float32))
    with pytest.raises(ValueError, match="all 16 slots within"):
        xyz_loop.cutoff_graph(conf, 16, t["cutoff"])


def test_the_control_fails_and_the_program_passes():
    r = control.readings(CELL, SEED, 0.3, True, device="cpu", traffic=tiny_size(CELL),
                         bench=bench())
    limits = load_json(BENCH, "limits", f"{CELL}.json")
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


def test_an_altered_or_a_stale_answer_is_not_correct(monkeypatch):
    from nmrgnn_tpu_torch.models.serving import ServingModel

    finalize = ServingModel._finalize

    def altered(peaks, inverse):
        out = np.array(finalize(peaks, inverse))
        out[..., 0] += 0.01 * float(np.abs(out).max())
        return out

    monkeypatch.setattr(ServingModel, "_finalize", staticmethod(altered))
    out = rehearse(CELL)
    assert not out["correct"] and out["failed"] == 1, out["check"]
    first = []

    def stale(peaks, inverse):
        out = finalize(peaks, inverse)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(ServingModel, "_finalize", staticmethod(stale))
    assert not rehearse(CELL)["correct"]


def test_its_files_load_no_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.drivers.predict_loop_xyz, portbench.reference.painn\n"
            "import portbench.harness.weights_painn\n"
            "from portbench.harness.cell import load_module\n"
            "load_module(%r, 'f')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (ROOT, os.path.join(BENCH, "flops", "painn.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "nmrgnn_tpu"} & top
