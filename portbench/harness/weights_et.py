"""The equivariant-transformer family's weights and peak standards drawn
from the run's seed, on the device, in the port's parameter layout
(``models/gnn.py``):

    {"embed": {"kernel" [V, F]},
     "neighbor": {"embed": {"kernel" [V, F]}, "dist": Dense(R, F), "combine": Dense(2F, F)},
     "mp": [{"norm": {"weight", "bias"}, "q": Dense(F, F), "k": Dense(F, F),
             "v": Dense(F, 3F), "o": Dense(F, 3F), "vec": {"kernel" [F, 3F]},
             "dk": Dense(R, F), "dv": Dense(R, 3F)}] (L layers),
     "out_norm": {"weight", "bias"},
     "fc": [{"kernel", "bias"}] (F x F ..., F x F/2), "out": {"kernel" [F/2, V], "bias"},
     "peak_std" [V], "peak_avg" [V]}

Drawn as torchmd-net's ``reset_parameters`` draws them, from one uniform
draw of a ``torch.Generator`` on the device cut into leaves (as
``weights.py`` draws the other families): kernels xavier-uniform on their
own two dimensions, the two embeddings uniform of unit variance (in
place of ``nn.Embedding``'s standard normal), every bias 0, LayerNorm
weights 1; each element's peak mean uniform in [0, 150) ppm and its
spread in [1, 20) ppm.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .weights import _put


def _dense(path, d_in: int, d_out: int, bias: bool = True):
    out = [(path + ("kernel",), (d_in, d_out), "glorot", d_in, d_out)]
    if bias:
        out.append((path + ("bias",), (d_out,), "zero", 0, 0))
    return out


def _norm(path, F: int):
    return [(path + ("weight",), (F,), "one", 0, 0), (path + ("bias",), (F,), "zero", 0, 0)]


def _layout(cfg: dict):
    """[(path, shape, kind, fan_in, fan_out)] in draw order."""
    F, R, V = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["num_elements"]
    out = [(("embed", "kernel"), (V, F), "unit", 0, 0),
           (("neighbor", "embed", "kernel"), (V, F), "unit", 0, 0)]
    out += _dense(("neighbor", "dist"), R, F) + _dense(("neighbor", "combine"), 2 * F, F)
    for i in range(cfg["mp_layers"]):
        out += (_norm(("mp", i, "norm"), F) + _dense(("mp", i, "q"), F, F)
                + _dense(("mp", i, "k"), F, F) + _dense(("mp", i, "v"), F, 3 * F)
                + _dense(("mp", i, "o"), F, 3 * F) + _dense(("mp", i, "vec"), F, 3 * F, bias=False)
                + _dense(("mp", i, "dk"), R, F) + _dense(("mp", i, "dv"), R, 3 * F))
    out += _norm(("out_norm",), F)
    for i in range(cfg["fc_layers"]):
        out += _dense(("fc", i), F, F if i < cfg["fc_layers"] - 1 else F // 2)
    out += _dense(("out",), F // 2, V)
    return out + [(("peak_std",), (V,), "std", 0, 0), (("peak_avg",), (V,), "avg", 0, 0)]


def draw_params(cfg: dict, seed: int, device) -> dict:
    """The params tree of ``cfg`` (the ``torchmd-et`` configuration's dict)
    for ``seed``, float32 on ``device``."""
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
        elif kind == "unit":
            leaf = (2 * x - 1) * math.sqrt(3.0)
        elif kind == "zero":
            leaf = torch.zeros_like(x)
        elif kind == "one":
            leaf = torch.ones_like(x)
        elif kind == "std":
            leaf = 1.0 + 19.0 * x
        else:
            leaf = 150.0 * x
        _put(tree, path, leaf.contiguous())
    return tree
