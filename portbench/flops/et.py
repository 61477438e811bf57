"""The least work of the equivariant-transformer family's inference
forward (``nmrgnn_tpu_torch/ops/et.py``), from the configuration and the
real atoms and edges, counted as ``flops/painn.py`` counts: products only
(a multiply-add 2, a product alone 1; activations and exponentials not
counted), each input read once and each output written once, in float32.
F atom features, R radial functions, H heads, L layers; an atom's self
term counts as one more edge in the attention (e' = e + n).

    filter, a real edge:          5 (d^2) + 3 (r^) + 1 (C) + 3R (the basis: its
                                  square, beta and C); writes f [R], C and r^ [3]
    embed:   a real edge          2RF (Dense(R, F)) + F (times C) + 2F (times
                                  E_nb(z_j), summed)
             an atom              4F^2 (Dense(2F, F))
    attn, a layer, an edge e':    2RF (dk) + 6RF (dv) + 3F (q k dk, summed) + H
                                  (times C) + 3F (v_j dv) + 2F (a s, summed)
                                  + 6F (v_j m1, summed) + 6F (m2 r^, summed)
                                  = 8RF + 20F + H
    update, a layer, an atom:     5F (LayerNorm) + 4F^2 (q, k) + 6F^2 (v)
                                  + 18F^2 (the vector projection) + 6F (vec_dot)
                                  + 6F^2 (o) + 2F + 6F (the residuals)
                                  = 34F^2 + 19F
    readout, an atom:             5F (the last LayerNorm), then as the bilinear
                                  family's FC block and head
The embeddings of a one-hot row are row lookups: no operations.
"""
from __future__ import annotations

B = 4  # bytes of a float32


def work(cfg: dict, n_atoms: int, n_edges: int) -> dict:
    """{"filter", "embed", "attn" (all layers), "update" (all layers), "mp"
    (attn + update), "readout": (flops, bytes), "forward": flops} of one
    forward over a graph of ``n_atoms`` atoms and ``n_edges`` real edges."""
    F, R, V = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["num_elements"]
    H, L = cfg["edge_feature_size"], cfg["mp_layers"]
    n, e = n_atoms, n_edges
    ep = e + n
    filt = ((3 * R + 9) * e, B * (3 * n + e + e * (R + 4)))
    embed_w = V * F + R * F + F + 2 * F * F + F
    embed = ((2 * R * F + 3 * F) * e + 4 * F * F * n,
             B * (e * (R + 2) + 2 * n * F + embed_w))
    attn = (L * (8 * R * F + 20 * F + H) * ep,
            L * B * (ep * (R + 5) + 12 * n * F + 4 * F * (R + 1)))
    update_w = 2 * F + 2 * (F * F + F) + 2 * (3 * F * F + 3 * F) + 3 * F * F
    update = (L * (34 * F * F + 19 * F) * n, L * B * (17 * n * F + update_w))
    fc = cfg["fc_layers"] - 1
    readout_w = 2 * F + fc * (F * F + F) + F * F // 2 + F // 2 + F // 2 * V + V
    readout = ((5 * F + 2 * fc * F * F + F * F + F * V) * n,
               B * (n * (F + V + 1) + readout_w))
    mp = (attn[0] + update[0], attn[1] + update[1])
    return {"filter": filt, "embed": embed, "attn": attn, "update": update, "mp": mp,
            "readout": readout, "forward": filt[0] + embed[0] + mp[0] + readout[0]}
