"""The least work of the bilinear family's inference forward (MPLayer),
from the configuration and the real atoms and edges: the operations and
bytes the mathematics needs, whatever implements it. Only products count
as operations (2 a multiply-add); bytes count each input read once and
each output written once, in float32.

    edge stage (RBF + EdgeFC), a real edge:  2 (L H^2 + H E), L = edge_fc_layers - 1
    an MP layer:                             2 E F per real edge + 2 E F^2 per atom
    FC block and head, an atom:              2 (fc_layers - 1) F^2 + F^2 + F V
The embedding of a one-hot row is a row lookup: no operations.
"""
from __future__ import annotations

B = 4  # bytes of a float32


def work(cfg: dict, n_atoms: int, n_edges: int) -> dict:
    """{"edge": (flops, bytes), "mp": (flops, bytes) of all MP layers,
    "readout": (flops, bytes), "forward": flops} of one forward over a
    graph of ``n_atoms`` atoms and ``n_edges`` real edges."""
    F, E, H, V = (cfg["atom_feature_size"], cfg["edge_feature_size"],
                  cfg["edge_hidden_size"], cfg["num_elements"])
    L = cfg["edge_fc_layers"] - 1
    edge_w = L * (H * H + H) + H * E + E
    edge = (2 * (L * H * H + H * E) * n_edges, B * (n_edges + edge_w + n_edges * E))
    layer_flops = 2 * E * F * n_edges + 2 * E * F * F * n_atoms
    layer_bytes = B * (2 * n_atoms * F + n_edges * (E + 1) + n_atoms + F * F * E)
    mp = (cfg["mp_layers"] * layer_flops, cfg["mp_layers"] * layer_bytes)
    fc = cfg["fc_layers"] - 1
    readout_w = fc * (F * F + F) + F * F // 2 + F // 2 + F // 2 * V + V
    readout = ((2 * fc * F * F + F * F + F * V) * n_atoms,
               B * (n_atoms * (F + V + 1) + readout_w))
    return {"edge": edge, "mp": mp, "readout": readout,
            "forward": edge[0] + mp[0] + readout[0]}
