"""The least work of the PaiNN family's inference forward
(``nmrgnn_tpu_torch/ops/painn.py``), from the configuration and the real
atoms and edges, counted as ``flops/bilinear.py`` counts: products only (a
multiply-add 2, a product alone 1), each input read once and each output
written once, in float32. F atom features, R radial functions, B blocks.

    filter, a real edge:            2 R 3BF (the Dense) + 3BF (the cutoff's scale);
                                    writes W [3BF] and r^ [3]
    message, a block:  an atom      2 F^2 + 6 F^2 (the context Dense layers)
                       a real edge  2F (W a x a, summed) + F + 6F (W b x b, times r^, summed)
                                    + F + 6F (W c x c, times v_j, summed) = 16F
    update, a block, an atom:       12 F^2 (v @ W_mix) + 10 F^2 (the mixing Dense layers)
                                    + 6F (|V|^2) + 6F (V . U) + 3F (b U) + F (c V.U)
    readout, an atom:               as the bilinear family's FC block and head
The embedding of a one-hot row is a row lookup: no operations.
"""
from __future__ import annotations

B = 4  # bytes of a float32


def work(cfg: dict, n_atoms: int, n_edges: int) -> dict:
    """{"filter", "message", "update" (all blocks), "mp" (message + update),
    "readout": (flops, bytes), "forward": flops} of one forward over a
    graph of ``n_atoms`` atoms and ``n_edges`` real edges."""
    F, R, V = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["num_elements"]
    blocks = cfg["mp_layers"]
    D = 3 * blocks * F
    n, e = n_atoms, n_edges
    filt = ((2 * R * D + D) * e, B * (3 * n + e + R * D + D + e * (D + 3)))
    ctx_w = F * F + F + 3 * F * F + 3 * F
    message = (blocks * (8 * F * F * n + 16 * F * e),
               blocks * B * (e * (3 * F + 3 + 1) + 2 * n * 4 * F + ctx_w))
    mix_w = 2 * F * F + F + 3 * F * F + 3 * F + 2 * F * F
    update = (blocks * (22 * F * F + 16 * F) * n, blocks * B * (2 * n * 4 * F + mix_w))
    fc = cfg["fc_layers"] - 1
    readout_w = fc * (F * F + F) + F * F // 2 + F // 2 + F // 2 * V + V
    readout = ((2 * fc * F * F + F * F + F * V) * n, B * (n * (F + V + 1) + readout_w))
    mp = (message[0] + update[0], message[1] + update[1])
    return {"filter": filt, "message": message, "update": update, "mp": mp, "readout": readout,
            "forward": filt[0] + mp[0] + readout[0]}
