"""Model weights and peak standards drawn from the run's seed, on the
device, in the port's parameter layout:

    {"embed": {"kernel" [V, F]}, "edge_fc": [{"kernel", "bias"}] (H x H ..., H x E),
     "mp": [{"w" [F, F, E]}] or [{"wq" [F, E], "wk" [E, E], "wv" [F, F]}],
     "fc": [{"kernel", "bias"}] (F x F ..., F x F/2), "out": {"kernel" [F/2, V], "bias"},
     "peak_std" [V], "peak_avg" [V]}

All of it comes from one uniform draw of a ``torch.Generator`` on the
device, cut into leaves: kernels glorot-uniform (an MP ``w`` takes the
rank-3 fans F*F and E*F), biases uniform in +-0.05, each element's peak
mean uniform in [0, 150) ppm and its spread in [1, 20) ppm.
"""
from __future__ import annotations

import numpy as np
import torch

BIAS = 0.05


def _layout(cfg: dict):
    """[(path, shape, kind, fan_in, fan_out)] in draw order."""
    F, E, H, V = (cfg["atom_feature_size"], cfg["edge_feature_size"],
                  cfg["edge_hidden_size"], cfg["num_elements"])
    out = [(("embed", "kernel"), (V, F), "glorot", V, F)]
    for i in range(cfg["edge_fc_layers"]):
        d_out = H if i < cfg["edge_fc_layers"] - 1 else E
        out += [(("edge_fc", i, "kernel"), (H, d_out), "glorot", H, d_out),
                (("edge_fc", i, "bias"), (d_out,), "bias", 0, 0)]
    for i in range(cfg["mp_layers"]):
        if cfg["mp_type"] == "attention":
            out += [(("mp", i, "wq"), (F, E), "glorot", F, E),
                    (("mp", i, "wk"), (E, E), "glorot", E, E),
                    (("mp", i, "wv"), (F, F), "glorot", F, F)]
        else:
            out.append((("mp", i, "w"), (F, F, E), "glorot", F * F, E * F))
    for i in range(cfg["fc_layers"]):
        d_out = F if i < cfg["fc_layers"] - 1 else F // 2
        out += [(("fc", i, "kernel"), (F, d_out), "glorot", F, d_out),
                (("fc", i, "bias"), (d_out,), "bias", 0, 0)]
    out += [(("out", "kernel"), (F // 2, V), "glorot", F // 2, V),
            (("out", "bias"), (V,), "bias", 0, 0),
            (("peak_std",), (V,), "std", 0, 0),
            (("peak_avg",), (V,), "avg", 0, 0)]
    return out


def _put(tree: dict, path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def draw_params(cfg: dict, seed: int, device) -> dict:
    """The params tree of ``cfg`` (a configuration file's dict) for
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
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            leaf = (2 * x - 1) * limit
        elif kind == "bias":
            leaf = (2 * x - 1) * BIAS
        elif kind == "std":
            leaf = 1.0 + 19.0 * x
        else:
            leaf = 150.0 * x
        _put(tree, path, leaf.contiguous())
    return tree


def copy_params(tree):
    """A detached copy of a params tree."""
    if isinstance(tree, dict):
        return {k: copy_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_params(v) for v in tree]
    return tree.detach().clone()


def count_params(tree) -> int:
    """Trainable parameters (peak_std and peak_avg are frozen)."""
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return t.numel()
    return count({k: v for k, v in tree.items() if k not in ("peak_std", "peak_avg")})
