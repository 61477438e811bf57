"""The least work of the MACE family's inference forward
(``nmrgnn_tpu_torch/ops/mace.py``), from the configuration and the real
atoms and edges, counted as ``flops/et.py`` counts: products only (a
multiply-add 2, a product alone 1; activations, sines and the embedding's
one-hot row lookups not counted), each input read once and each output
written once, in float32. F channels, R Bessel functions, V elements,
h~'s irreps ls_in and a layer's outputs Ls_out (the hidden 0..L, the last
layer 0 alone); a path p = (l1, l2, l3), d_l = 2l + 1, P_l3 the paths into
l3, eta_{nu,L} the symmetric contraction's paths.

    filter, a real edge:     5 (d^2) + 3 (r^) + 1 (x = d / r_c) + 8 (the
                             envelope) + 3R (the basis: n d, over d, times
                             the envelope) + 36 (Y to l = 3); writes Y [16]
                             and the basis [R]
    conv, a layer:
      a real edge            2 (R 64 + 64^2 (hidden - 1) + 64 P F) (the radial MLP)
                             + sum_p d_l2 F (w_p h~_j) + 2 d_l1 d_l2 F (the sum
                             over the slots with Y_l1)
      an atom                sum_p 2 d_l1 d_l2 d_l3 F (C on the sums)
                             + sum_l3 2 d_l3 P_l3 F^2 (the linear)
    product, a layer:
      an atom                sum_L d_L F 2 (16^3 + 16^2 + 16) (the chain of
                             contractions of A with each element's W U)
      once                   sum_L sum_nu 2 V F d_L 16^nu eta_{nu,L} (W U folded)
    update, a layer, an atom:
                             2 F^2 sum_ls_in d_l (Linear_up) + 2 F^2 16 (the
                             first layer's element mix of A) or 2 F^2 sum_Ls_out
                             d_L + F sum_Ls_out d_L (a later layer's skip and
                             its sum) + 2 F^2 sum_Ls_out d_L (Linear_prod)
    readout, an atom:        as the bilinear family's FC block and head
"""
from __future__ import annotations

from portbench.reference import mace as ref

B = 4  # bytes of a float32


def _d(l: int) -> int:
    return 2 * l + 1


def work(cfg: dict, n_atoms: int, n_edges: int) -> dict:
    """{"filter", "conv", "product", "update" (each over all layers), "mp"
    (conv + product + update), "readout": (flops, bytes), "forward": flops}
    of one forward over a graph of ``n_atoms`` atoms and ``n_edges`` real
    edges."""
    F, R, V = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["num_elements"]
    T, L_h, hidden = cfg["mp_layers"], cfg["edge_feature_size"], cfg["edge_fc_layers"]
    n, e = n_atoms, n_edges
    filt = ((53 + 3 * R) * e, B * (3 * n + e + e * (R + 16)))
    conv = product = update = (0, 0)
    ls_in = [0]
    for t in range(T):
        ls_out = [0] if t == T - 1 else list(range(L_h + 1))
        paths = ref.paths(ls_in)
        P = len(paths)
        widths = [R] + [64] * hidden + [P * F]
        radial_w = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        per_l3 = [sum(p[2] == l for p in paths) for l in range(ref.LMAX + 1)]
        edge = 2 * radial_w + sum(_d(l2) * F * (1 + 2 * _d(l1)) for l1, l2, _ in paths)
        atom = (sum(2 * _d(l1) * _d(l2) * _d(l3) * F for l1, l2, l3 in paths)
                + sum(2 * _d(l) * k * F * F for l, k in enumerate(per_l3)))
        lin_w = sum(k * F * F for k in per_l3)
        s_in = sum(_d(l) for l in ls_in)
        s_out = sum(_d(L) for L in ls_out)
        conv = (conv[0] + edge * e + atom * n,
                conv[1] + B * (e * (R + 16 + 1) + n * F * s_in + n * 16 * F + radial_w + lin_w))
        eta = {(nu, L): ref.u_basis(nu, L).shape[-1] for nu in (1, 2, 3) for L in ls_out}
        fold = sum(2 * V * F * _d(L) * 16 ** nu * eta[nu, L] for nu, L in eta)
        u_size = sum(_d(L) * 16 ** nu * eta[nu, L] for nu, L in eta)
        product = (product[0] + n * s_out * F * 2 * (16 ** 3 + 16 ** 2 + 16) + fold,
                   product[1] + B * (n * 16 * F + n * s_out * F + V * F * sum(eta.values())
                                     + u_size))
        if t == 0:  # the element mix of A: 4 kernels [V, F, F] over 16 rows
            mix, mix_rows, mix_w = 2 * F * F * 16, 2 * 16, ref.LMAX + 1
        else:       # the skip: a kernel [V, F, F] an output L
            mix, mix_rows, mix_w = 2 * F * F * s_out + F * s_out, 0, len(ls_out)
        update = (update[0] + n * (2 * F * F * s_in + mix + 2 * F * F * s_out),
                  update[1] + B * (n * F * (2 * s_in + mix_rows + 2 * s_out)
                                   + F * F * (s_in + V * mix_w + s_out)))
        ls_in = ls_out
    fc = cfg["fc_layers"] - 1
    readout_w = fc * (F * F + F) + F * F // 2 + F // 2 + F // 2 * V + V
    readout = ((2 * fc * F * F + F * F + F * V) * n, B * (n * (F + V + 1) + readout_w))
    mp = (conv[0] + product[0] + update[0], conv[1] + product[1] + update[1])
    return {"filter": filt, "conv": conv, "product": product, "update": update, "mp": mp,
            "readout": readout, "forward": filt[0] + mp[0] + readout[0]}
