"""The plain reference (``portbench/reference/``) against the port on the
CPU at a small size, and what it may import."""
import ast
import glob
import os

import numpy as np
import pytest
import torch

from portbench.harness import inputs
from portbench.harness.cell import load_json
from portbench.harness.weights import copy_params, count_params, draw_params
from portbench.reference import model as ref
from portbench.reference.structures import one_hot, synthetic_coords
from portbench.run import BENCH

CONFIGS = ["nmrgnn-baseline", "nmrgnn-amp"]


def _graph(n=300, seed=5):
    xyz, elements = synthetic_coords(n, np.random.default_rng(seed))
    nlist, d = inputs.knn_device(torch.as_tensor(xyz.astype(np.float32)), 16)
    return inputs.graph(one_hot(elements), nlist, d)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_have_the_published_parameter_count(name):
    cfg = load_json(BENCH, "configs", f"{name}.json")
    assert count_params(draw_params(cfg, 3, "cpu")) == cfg["parameters"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_ports_gather_forward(name):
    from nmrgnn_tpu_torch.config import ModelConfig
    from nmrgnn_tpu_torch.graph import Graph
    from nmrgnn_tpu_torch.models import gnn

    cfg = load_json(BENCH, "configs", f"{name}.json")
    params = draw_params(cfg, 2 ** 31 + 7, "cpu")
    g = [torch.as_tensor(a) for a in _graph()]
    fields = set(ModelConfig.__dataclass_fields__)
    port = gnn.apply(copy_params(params), ModelConfig(**{k: v for k, v in cfg.items()
                                                         if k in fields}), Graph(*g))
    want = ref.forward(params, cfg, *g)
    np.testing.assert_allclose(port.numpy(), want.numpy(), rtol=2e-5, atol=2e-5 * float(
        want.abs().max()))


def test_tf32_control_moves_the_peaks_more_than_float32_rounding():
    cfg = load_json(BENCH, "configs", "nmrgnn-baseline.json")
    params = draw_params(cfg, 11, "cpu")
    g = [torch.as_tensor(a) for a in _graph()]
    f32 = ref.forward(params, cfg, *g)
    tf32 = ref.forward(params, cfg, *g, prod=ref.Products(tf32=True))
    gap = float((tf32 - f32).abs().max() / f32.abs().max())
    assert 1e-5 < gap < 1e-1


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, -(1.0 + 3 * 2 ** -12), 3.0])
    got = ref.tf32_round(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 3.0]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_jax_nor_any_package_of_the_program():
    banned = {"jax", "jaxlib", "flax", "nmrgnn_tpu", "nmrgnn_tpu_torch"}
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in banned, (path, name)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "nmrgnn_tpu"}
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        for name in _imports(path):
            assert name.split(".")[0] not in banned, (path, name)
