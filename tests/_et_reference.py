"""Plain PyTorch reference of TorchMD-Net's equivariant transformer (Thölke
and De Fabritiis, "TorchMD-NET: Equivariant Transformers for Neural
Network based Molecular Potentials", ICLR 2022, arXiv:2202.02541;
torchmd-net ``models/torchmd_et.py``, ``models/utils.py``), in float32,
written from the paper's equations and torchmd-net, and nothing of the
program: the tests hold the port's ET family to it.

    r^_ij = (x_j - x_i) / d_ij;  d in Angstrom (10 x the graph's nm)
    C(d)  = (cos(pi d / r_c) + 1) / 2 below r_c, else 0
    f_ij  = C(d) exp(-beta (exp(-alpha (d - r_l)) - mu_n)^2),  n = 1..R
            alpha = 5 / (r_c - r_l), mu = linspace(exp(r_l - r_c), 1, R),
            beta = (2 / R (1 - exp(r_l - r_c)))^-2
    x = one_hot @ E
    x = W_c [x, sum_{j != i} (W_d f_ij + b_d) C(d_ij) (one_hot_j @ E_nb)] + b_c
    v = 0 [N, 3, F]; then each layer, over the edges j of i and i itself
    (d_ii = 0, C = 1, r^_ii = 0), H heads of D = F / H:
        y = LayerNorm(x);  q, k = W_q y + b_q, W_k y + b_k;  val = W_v y + b_v [H, 3D]
        u1, u2, u3 = v W_vec  (F each);  vec_dot = sum_xyz u1 u2
        dk = SiLU(W_dk f + b_dk) [H, D];  dv = SiLU(W_dv f + b_dv) [H, 3D]
        a_ij = SiLU(sum_d q_i k_j dk_ij) C(d_ij)            each head
        s, m1, m2 = split(val_j dv_ij, D)
        X_i = sum_j a_ij s;  V_i = sum_j (v_j m1 + m2 r^_ij)
        o1, o2, o3 = split(W_o X + b_o, F)
        x = x + vec_dot o2 + o3;  v = v + u3 o1 + V
    x = LayerNorm_out(x), then nmrgnn's readout.

Departures from torchmd-net, each forced by the nmrgnn task the port
serves:
  * the readout is nmrgnn's per-element head in place of the output
    model: Dense(F, F/2, SiLU), Dense(F/2, V), then each atom's own
    element's output times its peak std plus its peak mean;
  * the embeddings are one-hot rows over nmrgnn's V = 10 element
    vocabulary times [V, F] (no bias), not ``nn.Embedding(max_z)``;
  * the neighbors are a padded list of K slots an atom in place of
    ``max_num_neighbors`` (K = 80 in the benchmark, above every atom's
    count within r_c there, so the cap drops nothing): a slot whose graph
    distance is 0 is padding, and a slot at or past r_c is no edge (the
    radius graph holds none); neither adds anything.

``self_term=False`` leaves out the self term and ``mask_values=False``
lets the slots that are no edge add their value message, with r^ their
r_ij over 1 Angstrom (what the padding mask keeps out): each a mistake
the tests show the tolerance catches. The per-edge terms run in blocks
of ``block`` atoms. It imports neither JAX nor any package of the
program.
"""
from __future__ import annotations

import math

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def _layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p["weight"] + p["bias"]


def forward(p: dict, cfg: dict, atoms, nlist, edges, positions, block: int = 1024,
            self_term: bool = True, mask_values: bool = True) -> torch.Tensor:
    """Peaks f32[N] of one structure: ``atoms`` f32[N, V] one-hot, ``nlist``
    [N, K], ``edges`` f32[N, K] nm (0: padding), ``positions`` f32[N, 3] nm;
    ``cfg`` the model's fields (``atom_feature_size``, ``edge_hidden_size``,
    ``edge_feature_size`` the heads, ``rbf_low``, ``rbf_high``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F, R, H = cfg["atom_feature_size"], cfg["edge_hidden_size"], cfg["edge_feature_size"]
    D = F // H
    rl, rc = 10.0 * cfg["rbf_low"], 10.0 * cfg["rbf_high"]  # Angstrom
    dev = atoms.device
    n = atoms.shape[0]
    start = math.exp(rl - rc)
    mu = torch.linspace(start, 1.0, R, dtype=torch.float32, device=dev)
    beta = (2.0 / R * (1.0 - start)) ** -2
    alpha = 5.0 / (rc - rl)
    pos = positions * 10.0

    # the edges of each block of rows: index, in-graph mask, C, f, r^; the
    # self term as one more column
    blocks = []
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(r0 + block, n), device=dev)
        j = nlist[rows].long()
        r = pos[j] - pos[rows][:, None, :]
        d = torch.sqrt((r * r).sum(-1))
        edge = (edges[rows] > 0) & (d < rc)
        safe = torch.where(edge, d, torch.ones_like(d))
        unit = r / safe[..., None]
        if mask_values:
            unit = torch.where(edge[..., None], unit, torch.zeros_like(r))
        cut = torch.where(edge, 0.5 * (torch.cos(math.pi * safe / rc) + 1.0),
                          torch.zeros_like(d))
        basis = cut[..., None] * torch.exp(
            -beta * (torch.exp(-alpha * (safe - rl))[..., None] - mu) ** 2)
        blocks.append((rows, j, edge, cut, basis, unit))

    x = atoms @ p["embed"]["kernel"]
    nb = p["neighbor"]
    e_nb = atoms @ nb["embed"]["kernel"]
    agg = torch.zeros_like(x)
    for rows, j, edge, cut, basis, unit in blocks:
        w = _dense(nb["dist"], basis) * cut[..., None]
        agg[rows] = (w * e_nb[j]).sum(1)
    x = _dense(nb["combine"], torch.cat([x, agg], -1))

    f_self = torch.exp(-beta * (1.0 - mu) ** 2)  # d = 0, C = 1
    v = torch.zeros((n, 3, F), dtype=torch.float32, device=dev)
    for layer in p["mp"]:
        y = _layer_norm(layer["norm"], x)
        q = _dense(layer["q"], y).view(n, H, D)
        k = _dense(layer["k"], y).view(n, H, D)
        val = _dense(layer["v"], y).view(n, H, 3 * D)
        u = v @ layer["vec"]["kernel"]
        u1, u2, u3 = u[..., :F], u[..., F:2 * F], u[..., 2 * F:]
        vec_dot = (u1 * u2).sum(1)
        vh = v.view(n, 3, H, D)
        X = torch.zeros((n, H, D), dtype=torch.float32, device=dev)
        V = torch.zeros((n, 3, H, D), dtype=torch.float32, device=dev)
        for rows, j, edge, cut, basis, unit in blocks:
            dk = silu(_dense(layer["dk"], basis)).view(*j.shape, H, D)
            dv = silu(_dense(layer["dv"], basis)).view(*j.shape, H, 3 * D)
            a = silu((q[rows][:, None] * k[j] * dk).sum(-1)) * cut[..., None]
            m = val[j] * dv
            if mask_values:
                m = m * edge[..., None, None]
            s, m1, m2 = m[..., :D], m[..., D:2 * D], m[..., 2 * D:]
            X[rows] = (a[..., None] * s).sum(1)
            V[rows] = ((vh[j] * m1[:, :, None]).sum(1)
                       + (m2[:, :, None] * unit[..., None, None]).sum(1))
        if self_term:
            dk = silu(_dense(layer["dk"], f_self)).view(H, D)
            dv = silu(_dense(layer["dv"], f_self)).view(H, 3 * D)
            a = silu((q * k * dk).sum(-1))
            m = val * dv
            X = X + a[..., None] * m[..., :D]
            V = V + vh * m[:, None, :, D:2 * D]
        o = _dense(layer["o"], X.reshape(n, F))
        o1, o2, o3 = o[:, :F], o[:, F:2 * F], o[:, 2 * F:]
        x = x + vec_dot * o2 + o3
        v = v + u3 * o1[:, None, :] + V.reshape(n, 3, F)
    x = _layer_norm(p["out_norm"], x)
    for layer in p["fc"][:-1]:
        x = silu(_dense(layer, x)) + x
    x = silu(_dense(p["fc"][-1], x))
    full = _dense(p["out"], x)
    return torch.sum((full * p["peak_std"] + p["peak_avg"]) * atoms, dim=-1)
