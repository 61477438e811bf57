"""The least-work counts of ``flops/`` against the counts made by hand."""
import os

import pytest

from portbench.harness.cell import load_json, load_module
from portbench.run import BENCH

BASE = load_json(BENCH, "configs", "nmrgnn-baseline.json")
AMP = load_json(BENCH, "configs", "nmrgnn-amp.json")


def _work(family, cfg, n, edges, slots=None):
    mod = load_module(os.path.join(BENCH, "flops", f"{family}.py"), f"flops_{family}")
    return mod.work(cfg, n, edges) if slots is None else mod.work(cfg, n, edges, slots)


def test_baseline_counts_by_hand():
    # F=256, E=3, H=128, K=16, V=10; 4 EdgeFC, 4 MP, 4 FC layers
    w = _work("bilinear", BASE, 1, 16)
    assert w["edge"][0] == 16 * 2 * (3 * 128 * 128 + 128 * 3) == 16 * 99_072
    assert w["mp"][0] == 4 * (2 * 16 * 3 * 256 + 2 * 3 * 256 * 256) == 4 * 417_792
    assert w["readout"][0] == 2 * 3 * 256 * 256 + 2 * 256 * 128 + 2 * 128 * 10 == 461_312
    assert w["forward"] == 3_717_632


@pytest.mark.parametrize("n, gflop", [(2482, 9.227162624), (44676, 166.088927232)])
def test_baseline_forward_at_the_cells_sizes(n, gflop):
    assert _work("bilinear", BASE, n, 16 * n)["forward"] == pytest.approx(gflop * 1e9, rel=1e-12)


def test_attention_counts_values_once_an_atom():
    n, k = 1000, 16
    w = _work("attention", AMP, n, n * k, n * k)
    F, E = 256, 3
    layer = (2 * F * E + 2 * F * F) * n + (2 * E * E + 2 * E + 2 * F) * n * k
    assert w["mp"][0] == 4 * layer
    # not the N K F^2 of forming every slot's values
    assert w["mp"][0] < 4 * 2 * n * k * F * F / 10
    base = _work("bilinear", BASE, n, n * k)
    assert w["edge"] == base["edge"] and w["readout"] == base["readout"]


def test_bytes_count_each_input_once():
    n, k = 100, 16
    w = _work("bilinear", BASE, n, n * k)
    F, E = 256, 3
    assert w["mp"][1] == 4 * 4 * (2 * n * F + n * k * (E + 1) + n + F * F * E)
