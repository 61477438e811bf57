"""The port's kernel-launch layer (``nmrgnn_tpu_torch/ops/_cuda.py``) on
the CPU: one registry holds every kernel wrapper of the op modules, a CPU
forward of each family takes the plain versions and counts no launch,
and no op module reaches into a sibling's private names."""
import ast
import os
import sys

import numpy as np
import pytest
import torch

from nmrgnn_tpu_torch.config import ModelConfig
from nmrgnn_tpu_torch.graph import Graph
from nmrgnn_tpu_torch.models import gnn
from nmrgnn_tpu_torch.models.serving import ServingModel
from nmrgnn_tpu_torch.ops import _cuda, attention, banded, blocksparse, et, painn

torch.set_num_threads(2)

OPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "nmrgnn_tpu_torch", "ops")
KERNEL_MODULES = (attention, banded, blocksparse, et, painn)


def _tree(mod):
    with open(mod.__file__) as f:
        return ast.parse(f.read())


def _launchers(mod) -> set:
    """The public module-level functions of ``mod`` that launch a kernel:
    those whose body, or a module-level function it calls, calls
    ``launch``, read from the source."""
    defs = {n.name: n for n in _tree(mod).body if isinstance(n, ast.FunctionDef)}
    calls = {name: {c.func.id for c in ast.walk(node)
                    if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}
             for name, node in defs.items()}
    reach = {name for name, called in calls.items() if "launch" in called}
    grown = True
    while grown:
        more = {name for name, called in calls.items() if called & reach} - reach
        reach |= more
        grown = bool(more)
    return {name for name in reach if not name.startswith("_")}


def test_every_kernel_wrapper_is_in_the_one_registry():
    """Every public function of attention, banded, blocksparse, et and
    painn that launches a kernel is a counted wrapper in
    ``KERNEL_WRAPPERS`` (the request preparation's ``permute_tile_bounds``
    apart), ``painn.message``, ``attention.amp`` and
    ``et.fused_attention`` included, under a name of its own;
    ``reset_launch_counts`` zeroes them all and ``permute_tile_bounds``."""
    found = [getattr(mod, name) for mod in KERNEL_MODULES for name in _launchers(mod)]
    assert painn.message in found and blocksparse.mp_blocksparse_grouped in found
    assert attention.amp in found and et.fused_attention in found
    assert set(found) == set(_cuda.KERNEL_WRAPPERS) | {banded.permute_tile_bounds}
    assert banded.permute_tile_bounds not in _cuda.KERNEL_WRAPPERS
    names = [f.__name__ for f in _cuda.KERNEL_WRAPPERS]
    assert len(names) == len(set(names)) == 21
    for f in found:
        f.launches = 7
    _cuda.reset_launch_counts()
    assert all(f.launches == 0 for f in found)


def test_wrappers_keep_their_names_and_docstrings():
    for f in _cuda.KERNEL_WRAPPERS + (banded.permute_tile_bounds,):
        assert f.__doc__ and f.__wrapped__.__name__ == f.__name__
        assert getattr(sys.modules[f.__module__], f.__name__) is f


def _graph(n=300, k=12, seed=0):
    """(Graph of numpy arrays, positions f32[N, 3] nm): random atoms in a
    box, each with its k nearest neighbors."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nlist = np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)
    edges = np.take_along_axis(d, nlist, 1).astype(np.float32)
    atoms = np.eye(10, dtype=np.float32)[rng.integers(1, 6, n)]
    inv = np.full(n, 1.0 / k, np.float32)
    return Graph(atoms, nlist, edges, inv), pos


@pytest.mark.parametrize("family,mode", [("bilinear", "auto"), ("bilinear", "blocksparse"),
                                         ("attention", "auto"), ("painn", "auto"),
                                         ("et", "auto")])
def test_a_cpu_forward_counts_no_launch(family, mode):
    """A CPU forward of each family runs the plain versions: every
    wrapper's count stays 0."""
    cfg = ModelConfig(atom_feature_size=32, edge_hidden_size=16, mp_layers=2, fc_layers=1,
                      edge_fc_layers=2, neighbor_number=12, mp_type=family)
    if family in ("painn", "et"):
        cfg = cfg.replace(mp_activation="silu", fc_activation="silu", edge_fc_layers=1,
                          rbf_high=0.5)
    if family == "et":
        cfg = cfg.replace(edge_feature_size=4, rbf_low=0.0)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g, pos = _graph()
    _cuda.reset_launch_counts()
    model = ServingModel(params, cfg, device="cpu", mode=mode)
    peaks = model.predict(g, positions=pos if family in gnn.POSITIONS_FAMILIES else None)
    assert peaks.shape == (300,) and np.all(np.isfinite(peaks))
    assert all(f.launches == 0 for f in _cuda.KERNEL_WRAPPERS + (banded.permute_tile_bounds,))


def _private_imports(path) -> list:
    """The ``from .x import _name`` of an op module, x a sibling module."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return [(node.module, a.name) for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level == 1 and node.module
            for a in node.names if a.name.startswith("_")]


def test_no_op_module_imports_a_siblings_private_name(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("from . import _cuda\nfrom .banded import BandPlan, _check\n")
    assert _private_imports(bad) == [("banded", "_check")]
    paths = sorted(os.path.join(OPS, f) for f in os.listdir(OPS) if f.endswith(".py"))
    assert len(paths) >= 10
    assert {p: _private_imports(p) for p in paths} == {p: [] for p in paths}
