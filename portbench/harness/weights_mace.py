"""The MACE family's weights and peak standards drawn from the run's seed,
on the device, in the port's parameter layout (``models/gnn.py``):

    {"embed": {"kernel" [V, F]}, "avg_num_neighbors" [] (frozen),
     "mp": [{"up": [{"kernel" [F, F]}] an l of h,
             "radial": [{"kernel"}] R -> 64 -> 64 -> 64 -> P F,
             "linear": [{"kernel" [P_l3 F, F]}] l3 = 0..3,
             "skip": [{"kernel" [V, F, F]}] (the first layer: an l of A; later: an output L),
             "product": [{"w1", "w2", "w3" [V, eta, F]}] an output L,
             "out": [{"kernel" [F, F]}] an output L}] (T interactions),
     "fc": [{"kernel", "bias"}] (F x F ..., F x F/2), "out": {"kernel" [F/2, V], "bias"},
     "peak_std" [V], "peak_avg" [V]}

Drawn as mace and e3nn draw them, from one standard-normal draw of a
``torch.Generator`` on the device cut into leaves: each kernel standard
normal times e3nn's 1/sqrt(fan_in) (the embedding's V, a Linear's F or
P_l3 F, an element mix's F V, a radial layer's width in), each
contraction weight standard normal over its number of paths eta; the
readout's kernels the same and its biases 0. One departure: the Linear
after each convolution is drawn at ``LINEAR_GAIN`` times e3nn's scale.
At e3nn's scales alone A's rms is about 5e-4 in the first interaction
and 3e-6 in the second (the edge basis, 1e-2 near the cutoff, and the
element mix's 1/sqrt(V)), so the symmetric contraction's order-2 and
order-3 terms, and with them the l = 2, 3 paths, move the peaks by less
than float32 rounding and no check could see them. At the gain A's rms
is 0.1-0.2 in both interactions, and each order and each path of either
interaction moves the peaks by 2.6% or more of the largest, on the
traffic's frames, over 250 times the cell's limit; a larger gain lets
the order-3 terms run away at the atoms that the traffic's walk brings
within 0.5-0.8 A of another.
Then, from one uniform draw, each element's peak spread in [1, 20) ppm;
every peak mean is 0 ppm, so that the check compares the network's part
(about 1-15 ppm at the gain) and not the means. ``avg_num_neighbors`` is the
configuration's. The paths and their counts eta are
``reference/mace.py``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import mace as ref
from .weights import _put

# the post-convolution Linears' gain over e3nn's scale (docstring)
LINEAR_GAIN = 200.0


def _layout(cfg: dict):
    """[(path, shape, scale)] in draw order: leaf = standard normal x scale."""
    F, R, V = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["num_elements"]
    T, L_h = cfg["mp_layers"], cfg["edge_feature_size"]
    out = [(("embed", "kernel"), (V, F), V ** -0.5)]
    ls_in = [0]
    for i in range(T):
        ls_out = [0] if i == T - 1 else list(range(L_h + 1))
        paths = ref.paths(ls_in)
        widths = [R] + [64] * cfg["edge_fc_layers"] + [len(paths) * F]
        out += [(("mp", i, "up", k, "kernel"), (F, F), F ** -0.5) for k in range(len(ls_in))]
        out += [(("mp", i, "radial", k, "kernel"), (a, b), a ** -0.5)
                for k, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]
        for l3 in range(ref.LMAX + 1):
            n = sum(p[2] == l3 for p in paths) * F
            out.append((("mp", i, "linear", l3, "kernel"), (n, F), LINEAR_GAIN * n ** -0.5))
        mixed = range(ref.LMAX + 1) if i == 0 else range(len(ls_out))
        out += [(("mp", i, "skip", k, "kernel"), (V, F, F), (F * V) ** -0.5) for k in mixed]
        for k, L in enumerate(ls_out):
            for nu in (1, 2, 3):
                eta = ref.u_basis(nu, L).shape[-1]
                out.append((("mp", i, "product", k, f"w{nu}"), (V, eta, F), 1.0 / eta))
        out += [(("mp", i, "out", k, "kernel"), (F, F), F ** -0.5) for k in range(len(ls_out))]
        ls_in = ls_out
    for i in range(cfg["fc_layers"]):
        d_out = F if i < cfg["fc_layers"] - 1 else F // 2
        out += [(("fc", i, "kernel"), (F, d_out), F ** -0.5), (("fc", i, "bias"), (d_out,), 0.0)]
    out += [(("out", "kernel"), (F // 2, V), (F // 2) ** -0.5), (("out", "bias"), (V,), 0.0)]
    return out


def draw_params(cfg: dict, seed: int, device) -> dict:
    """The params tree of ``cfg`` (the ``mace-off23-medium`` configuration's
    dict) for ``seed``, float32 on ``device``."""
    layout = _layout(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _ in layout]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    g = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    offset = 0
    for (path, shape, scale), size in zip(layout, sizes):
        _put(tree, path, (g[offset:offset + size].view(shape) * scale).contiguous())
        offset += size
    V = cfg["num_elements"]
    u = torch.rand(V, generator=gen, device=device, dtype=torch.float32)
    tree["peak_std"] = 1.0 + 19.0 * u
    tree["peak_avg"] = torch.zeros(V, device=device)
    tree["avg_num_neighbors"] = torch.tensor(float(cfg["avg_num_neighbors"]), device=device)
    return tree
