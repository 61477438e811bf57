"""The ``torchmd-et`` configuration's benchmark files on the CPU: its
weights' draw, its reference (``reference/et.py``) against the port's
forward, its least work (``flops/et.py``) against a hand count, what
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
from portbench.harness.weights import copy_params, count_params
from portbench.harness.weights_et import draw_params
from portbench.reference import et as ref
from portbench.reference.model import Products
from portbench.reference.structures import one_hot
from portbench.run import BENCH, ROOT
from portbench.tests.tiny import SEED, bench, tiny_size

CFG = load_json(BENCH, "configs", "torchmd-et.json")
CELL = "et-predict-44676"


def _structure(atoms=120, k=80):
    """(graph tensors, positions nm) of one small chain at the traffic's
    lattice and cutoff."""
    t = {**load_json(BENCH, "traffic", "predict-44676-r5-et.json"), "atoms": atoms,
         "grid": [1, 1, 1]}
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
    assert count_params(params) == CFG["parameters"] == 6_507_914
    port = gnn.init_params(_model_config(), torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: [tuple(t.shape) for t in gnn.tree_leaves(tree)]  # noqa: E731
    assert shapes(params) == shapes(port)
    layer = params["mp"][0]
    assert float(layer["dv"]["bias"].abs().max()) == 0.0
    assert float(layer["norm"]["weight"].min()) == float(layer["norm"]["weight"].max()) == 1.0
    assert 0.9 < float(params["embed"]["kernel"].std()) < 1.1


def test_reference_equals_the_ports_forward():
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn

    g, pos = _structure()
    assert (g[2] == 0).any()  # slots past the cutoff are padding
    params = draw_params(CFG, 2 ** 31 + 7, "cpu")
    # the program's own slots: nonzero biases, so that padding would show
    gen = torch.Generator().manual_seed(1)
    for layer in params["mp"]:
        for name in ("dk", "dv", "v"):
            layer[name]["bias"] = 0.05 * (2 * torch.rand(layer[name]["bias"].shape,
                                                         generator=gen) - 1)
    got = gnn.apply(copy_params(params), _model_config(), Graph(*g), positions=pos).numpy()
    want = ref.forward(params, CFG, *g[:3], pos).numpy()
    assert np.max(np.abs(got - want)) <= 2e-6 * np.max(np.abs(want))
    tf32 = ref.forward(params, CFG, *g[:3], pos, prod=Products(tf32=True)).numpy()
    assert np.max(np.abs(tf32 - want)) > 2e-6 * np.max(np.abs(want))


def test_reference_blocks_do_not_change_the_peaks():
    g, pos = _structure()
    params = draw_params(CFG, 5, "cpu")
    whole = ref.forward(params, CFG, *g[:3], pos)
    parts = ref.forward(params, CFG, *g[:3], pos, block=7)
    assert torch.allclose(parts, whole, rtol=1e-6, atol=0)


def test_least_work_by_hand():
    mod = load_module(os.path.join(BENCH, "flops", "et.py"), "flops_et")
    n, e = 10, 300
    w = mod.work(CFG, n, e)
    F, R, V, H, L = 256, 64, 10, 8, 8
    assert w["filter"][0] == e * (3 * R + 9)
    assert w["embed"][0] == e * (2 * R * F + 3 * F) + n * 2 * (2 * F) * F
    edge = 2 * R * F + 2 * R * 3 * F + 3 * F + H + 3 * F + 2 * F + 6 * F + 6 * F
    assert w["attn"][0] == L * (e + n) * edge
    atom = 5 * F + 2 * 2 * F * F + 2 * F * 3 * F + 3 * 2 * F * 3 * F + 6 * F + 2 * F * 3 * F
    assert w["update"][0] == L * n * (atom + 2 * F + 6 * F)
    assert w["readout"][0] == n * (5 * F + 2 * F * F // 2 + 2 * F // 2 * V)
    assert w["mp"][0] == w["attn"][0] + w["update"][0]
    assert w["forward"] == w["filter"][0] + w["embed"][0] + w["mp"][0] + w["readout"][0]
    # bytes: each input read once, each output written once, float32
    assert w["filter"][1] == 4 * (3 * n + e + e * (R + 4))
    assert w["attn"][1] == L * 4 * ((e + n) * (R + 5) + 12 * n * F + 4 * F * (R + 1))
    # the cell's size: about 3.61 TFLOP a forward, the attention 2.72 of it
    full = mod.work(CFG, 44676, 2_451_000)
    assert full["forward"] == pytest.approx(3.6149e12, rel=1e-3)
    assert full["attn"][0] == pytest.approx(2.7193e12, rel=1e-3)
    assert full["update"][0] == pytest.approx(0.7981e12, rel=1e-3)


def test_the_control_fails_and_the_program_passes():
    r = control.readings(CELL, SEED, 3.0, True, device="cpu", traffic=tiny_size(CELL),
                         bench=bench())
    limits = load_json(BENCH, "limits", f"{CELL}.json")
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


def test_its_files_load_no_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.drivers.predict_loop_et, portbench.reference.et\n"
            "import portbench.harness.weights_et\n"
            "from portbench.harness.cell import load_module\n"
            "load_module(%r, 'f')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (ROOT, os.path.join(BENCH, "flops", "et.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "nmrgnn_tpu"} & top
