"""The PaiNN family's weights and peak standards drawn from the run's seed,
on the device, in the port's parameter layout (``models/gnn.py``):

    {"embed": {"kernel" [V, F]}, "filter": {"kernel" [R, B 3F], "bias"},
     "mp": [{"context": [Dense(F, F), Dense(F, 3F)], "mix": [Dense(2F, F), Dense(F, 3F)],
             "channel_mix": {"kernel" [F, 2F]}}] (B blocks),
     "fc": [{"kernel", "bias"}] (F x F ..., F x F/2), "out": {"kernel" [F/2, V], "bias"},
     "peak_std" [V], "peak_avg" [V]}

Drawn as ``weights.py`` draws the other families: one uniform draw of a
``torch.Generator`` on the device cut into leaves, kernels glorot-uniform
on their own two dimensions, biases uniform in +-0.05, each element's peak
mean uniform in [0, 150) ppm and its spread in [1, 20) ppm.
"""
from __future__ import annotations

import numpy as np
import torch

from .weights import BIAS, _put


def _dense(path, d_in: int, d_out: int, bias: bool = True):
    out = [(path + ("kernel",), (d_in, d_out), "glorot", d_in, d_out)]
    if bias:
        out.append((path + ("bias",), (d_out,), "bias", 0, 0))
    return out


def _layout(cfg: dict):
    """[(path, shape, kind, fan_in, fan_out)] in draw order."""
    F, R, V = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["num_elements"]
    out = _dense(("embed",), V, F, bias=False)
    out += _dense(("filter",), R, 3 * F * cfg["mp_layers"])
    for i in range(cfg["mp_layers"]):
        out += (_dense(("mp", i, "context", 0), F, F) + _dense(("mp", i, "context", 1), F, 3 * F)
                + _dense(("mp", i, "mix", 0), 2 * F, F) + _dense(("mp", i, "mix", 1), F, 3 * F)
                + _dense(("mp", i, "channel_mix"), F, 2 * F, bias=False))
    for i in range(cfg["fc_layers"]):
        out += _dense(("fc", i), F, F if i < cfg["fc_layers"] - 1 else F // 2)
    out += _dense(("out",), F // 2, V)
    return out + [(("peak_std",), (V,), "std", 0, 0), (("peak_avg",), (V,), "avg", 0, 0)]


def draw_params(cfg: dict, seed: int, device) -> dict:
    """The params tree of ``cfg`` (the ``painn`` configuration's dict) for
    ``seed``, float32 on ``device``."""
    layout = _layout(cfg)
    sizes = [int(np.prod(shape)) for _, shape, *_ in layout]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    offset = 0
    for (path, shape, kind, fan_in, fan_out), size in zip(layout, sizes):
        x = u[offset:offset + size].view(shape)
        offset += size
        if kind == "glorot":
            leaf = (2 * x - 1) * float(np.sqrt(6.0 / (fan_in + fan_out)))
        elif kind == "bias":
            leaf = (2 * x - 1) * BIAS
        elif kind == "std":
            leaf = 1.0 + 19.0 * x
        else:
            leaf = 150.0 * x
        _put(tree, path, leaf.contiguous())
    return tree
