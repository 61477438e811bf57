"""The ``mace-off23-medium`` configuration's benchmark files on the CPU: its
weights' draw, its reference (``reference/mace.py``) against the port's
forward, its least work (``flops/mace.py``) against a hand count, what
decides ``correct`` for its cell, and what its files import. The cell
itself rehearses through ``test_portbench_cells.py`` by its tiny size."""
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
from portbench.harness.weights import copy_params
from portbench.harness.weights_mace import draw_params
from portbench.reference import mace as ref
from portbench.reference.model import Products
from portbench.reference.structures import one_hot
from portbench.run import BENCH, ROOT
from portbench.tests.tiny import SEED, bench, tiny_size

CFG = load_json(BENCH, "configs", "mace-off23-medium.json")
CELL = "mace-predict-44676"


def _structure(atoms=150, k=80):
    """(graph tensors, positions nm) of one small chain at the traffic's
    lattice and cutoff."""
    t = {**load_json(BENCH, "traffic", "predict-44676-r5-mace.json"), "atoms": atoms,
         "grid": [1, 1, 1]}
    xyz, elements = xyz_loop.supercell(t)
    conf = torch.as_tensor(xyz.astype(np.float32))
    nlist, dists = xyz_loop.cutoff_graph(conf, min(k, atoms - 1), t["cutoff"])
    g = inputs.graph(one_hot(elements), nlist, dists)
    return [torch.as_tensor(a) for a in g], conf * 0.1


def _model_config():
    return Cell(name=CELL, root=BENCH, config=CFG, traffic={}, seed=0,
                device=torch.device("cpu")).model_config()


def test_weights_have_the_configurations_parameter_count_and_the_ports_layout():
    from nmrgnn_tpu_torch.models import gnn

    params = draw_params(CFG, 3, "cpu")
    assert gnn.count_params(params) == CFG["parameters"] == 1_342_922
    port = gnn.init_params(_model_config(), torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: [tuple(t.shape) for t in gnn.tree_leaves(tree)]  # noqa: E731
    assert shapes(params) == shapes(port)
    assert float(params["avg_num_neighbors"]) == 55.0
    assert float(params["peak_avg"].abs().max()) == 0.0
    # e3nn's scales: a Linear's 1/sqrt(F), the element mix's 1/sqrt(F V)
    up = params["mp"][1]["up"][1]["kernel"]
    assert 0.9 < float(up.std()) * 128 ** 0.5 < 1.1
    skip = params["mp"][0]["skip"][2]["kernel"]
    assert 0.9 < float(skip.std()) * 1280 ** 0.5 < 1.1


def test_reference_equals_the_ports_forward():
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn

    g, pos = _structure()
    assert (g[2] == 0).any()  # slots past the cutoff are padding
    params = draw_params(CFG, 2 ** 31 + 7, "cpu")
    got = gnn.apply(copy_params(params), _model_config(), Graph(*g), positions=pos).numpy()
    want = ref.forward(params, CFG, *g[:3], pos).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    tf32 = ref.forward(params, CFG, *g[:3], pos, prod=Products(tf32=True)).numpy()
    assert np.max(np.abs(tf32 - want)) > 1e-4 * np.max(np.abs(want))


def test_reference_blocks_do_not_change_the_peaks():
    g, pos = _structure(atoms=100)
    params = draw_params(CFG, 5, "cpu")
    whole = ref.forward(params, CFG, *g[:3], pos)
    parts = ref.forward(params, CFG, *g[:3], pos, block=7)
    assert torch.allclose(parts, whole, rtol=1e-5, atol=1e-6 * float(whole.abs().max()))


def test_least_work_by_hand():
    mod = load_module(os.path.join(BENCH, "flops", "mace.py"), "flops_mace")
    n, e = 10, 300
    w = mod.work(CFG, n, e)
    F, R, V = 128, 8, 10
    assert w["filter"][0] == e * (53 + 3 * R)
    # layer 1: 4 paths (l, 0, l); layer 2: 10 paths
    radial = 2 * (R * 64 + 64 * 64 * 2 + 64 * 4 * F) + 2 * (R * 64 + 64 * 64 * 2 + 64 * 10 * F)
    tp1 = F * sum(1 + 2 * (2 * l + 1) for l in range(4))
    tp2 = tp1 + 3 * F * ((1 + 2) + 2 * (1 + 6) + 2 * (1 + 10) + (1 + 14))
    cg1 = 2 * F * sum((2 * l + 1) ** 2 for l in range(4))
    cg2 = cg1 + 2 * F * 3 * (3 + 3 + 15 + 15 + 35 + 35)
    linear = 2 * F * F * (16 + (1 * 2 + 3 * 3 + 5 * 3 + 7 * 2))
    assert w["conv"][0] == e * (radial + tp1 + tp2) + n * (cg1 + cg2 + linear)
    chain = 2 * (16 ** 3 + 16 ** 2 + 16)
    fold = 2 * V * F * (1 * (16 + 256 * 4 + 4096 * 8) + 3 * (16 + 256 * 3 + 4096 * 12)
                        + 1 * (16 + 256 * 4 + 4096 * 8))
    assert w["product"][0] == n * F * chain * (4 + 1) + fold
    assert w["update"][0] == n * (2 * F * F * (1 + 16 + 4) + 2 * F * F * (4 + 1 + 1) + F)
    assert w["readout"][0] == n * (F * F + F * V)
    assert w["mp"][0] == w["conv"][0] + w["product"][0] + w["update"][0]
    assert w["forward"] == w["filter"][0] + w["mp"][0] + w["readout"][0]
    # bytes: each input read once, each output written once, float32
    assert w["filter"][1] == 4 * (3 * n + e + e * (R + 16))
    # the cell's size: about 1.10 TFLOP a forward, the convolutions 0.81 of it
    full = mod.work(CFG, 44676, 2_451_000)
    assert full["forward"] == pytest.approx(1.0993e12, rel=1e-3)
    assert full["conv"][0] == pytest.approx(0.8085e12, rel=1e-3)
    assert full["product"][0] == pytest.approx(0.2503e12, rel=1e-3)


def test_the_control_fails_and_the_program_passes():
    r = control.readings(CELL, SEED, 3.0, True, device="cpu", traffic=tiny_size(CELL),
                         bench=bench())
    limits = load_json(BENCH, "limits", f"{CELL}.json")
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


def _fault(kind, t, params):
    """The served copy of ``params`` with one part of interaction ``t``
    taken out: ``w2`` or ``w3`` (an order of the contraction) or
    ``l3_2_3`` (the Linears of the paths that end in l3 = 2 and 3)."""
    params = copy_params(params)
    layer = params["mp"][t]
    if kind in ("w2", "w3"):
        for w in layer["product"]:
            w[kind].zero_()
    else:
        for l3 in (2, 3):
            layer["linear"][l3]["kernel"].zero_()
    return params


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("kind", ["w2", "w3", "l3_2_3"])
def test_the_check_sees_each_order_and_the_l2_l3_paths(monkeypatch, kind, t):
    """Served weights without the order-2 or order-3 contraction, or
    without the l3 = 2, 3 paths' Linears, of either interaction, read far
    past the limit."""
    from portbench.drivers import predict_loop_mace

    monkeypatch.setattr(predict_loop_mace, "copy_params", lambda p: _fault(kind, t, p))
    r = control.readings(CELL, SEED, 1.0, False, device="cpu", traffic=tiny_size(CELL),
                         bench=bench())
    limits = load_json(BENCH, "limits", f"{CELL}.json")
    assert all(v > 10 * limits[k] for k, v in r["program"].items()), r


def test_its_files_load_no_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.drivers.predict_loop_mace, portbench.reference.mace\n"
            "import portbench.harness.weights_mace\n"
            "from portbench.harness.cell import load_module\n"
            "load_module(%r, 'f')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (ROOT, os.path.join(BENCH, "flops", "mace.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "nmrgnn_tpu"} & top
