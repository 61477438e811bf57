"""Inputs the benchmark makes and hands to the program and to the
reference alike: graphs of coordinates (its own k-NN on the device)."""
from __future__ import annotations

import numpy as np
import torch

from ..reference.structures import ANGSTROM_TO_NM, inv_degree


def knn_device(coords: torch.Tensor, k: int, block: int = 4096, spare: int = 8):
    """(nlist i32[N, k], dists f32[N, k] Angstrom) of ``coords`` f32[N, 3]
    on their device: ``k + spare`` candidates a row from |x|^2 + |y|^2 -
    2 x.y (TF32 off), then ranked by their distances taken from the
    coordinates' differences, so that the cancellation of the first form
    moves no neighbor."""
    n = coords.shape[0]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sq = (coords * coords).sum(-1)
        cols = torch.arange(n, device=coords.device)
        nl, ds = [], []
        c = min(k + spare, n - 1)
        for r0 in range(0, n, block):
            rows = coords[r0:r0 + block]
            d2 = sq[r0:r0 + block, None] + sq[None, :] - 2.0 * (rows @ coords.T)
            d2[cols[:rows.shape[0]], cols[r0:r0 + rows.shape[0]]] = float("inf")
            cand = torch.topk(d2, c, dim=-1, largest=False).indices
            exact = (coords[cand] - rows[:, None, :]).pow(2).sum(-1).sqrt()
            d, order = torch.sort(exact, dim=-1, stable=True)
            nl.append(torch.gather(cand, 1, order[:, :k]))
            ds.append(d[:, :k])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.cat(nl).to(torch.int32), torch.cat(ds)


def graph(atoms: np.ndarray, nlist: torch.Tensor, dists: torch.Tensor):
    """(atoms f32[N, V], nlist i32[N, K], edges f32[N, K] nm, inv_degree
    f32[N]) as numpy arrays: the program's graph input."""
    nl = nlist.cpu().numpy()
    return (atoms, nl, (dists.cpu().numpy() * ANGSTROM_TO_NM).astype(np.float32),
            inv_degree(nl))
