"""Exact k-nearest-neighbor lists (``nmrgnn_tpu/data/neighbors.py``).

* ``neighbors_host``: the native cell list (``nmrgnn_tpu_torch/native.py``)
  when its library builds and loads, scipy's cKDTree otherwise, the JAX
  package's rule, so both packages build the same graphs (tied neighbors
  in the same slots, distances to the bit).
* ``neighbors_device``: blocked |x|^2 + |y|^2 - 2 x.y distances and a
  top-k on the coordinates' device (the card), so trajectory frames can be
  built there.

Both return (nlist i32[N, K], dists f32[N, K]) sorted by increasing
distance, self excluded, in the units of ``coords``. Slots beyond the true
neighbor count (N - 1 < K) hold index 0 and distance 0.
"""
from __future__ import annotations

import numpy as np
import torch


def neighbors_host(coords: np.ndarray, k: int, use_native: bool = True):
    """Exact k-NN on the host: the native cell list when built (and N > k),
    scipy's cKDTree otherwise. coords: f32[N, 3]."""
    if use_native and coords.shape[0] > k:
        from .. import native

        out = native.cell_list_knn(coords, k)
        if out is not None:
            return out
    from scipy.spatial import cKDTree

    n = coords.shape[0]
    kk = min(k + 1, n)
    dists, idx = cKDTree(coords).query(coords, k=kk)
    if kk == 1:
        dists = dists[:, None]
        idx = idx[:, None]
    # drop self (the first column is always self at distance 0)
    dists, idx = dists[:, 1:], idx[:, 1:]
    out_i = np.zeros((n, k), np.int32)
    out_d = np.zeros((n, k), np.float32)
    m = dists.shape[1]
    out_i[:, :m] = idx
    out_d[:, :m] = dists
    return out_i, out_d


def smallest_k(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries of each row of the
    float32 ``x`` (any sign, inf allowed; -0 equals +0), ascending, ties to
    the lower index, as ``jax.lax.top_k`` of -x orders them
    (``torch.topk`` does not promise an order among ties). Each column's
    key is an int64: its value's bits made monotone (a negative value's
    magnitude negated) above its index, so the top-k of the keys is exact."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    mono = torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))
    cols = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    keys = torch.topk((mono << 32) | cols, k, dim=-1, largest=False, sorted=True).values
    top = keys >> 32
    vbits = torch.where(top >= 0, top, (-top) | 0x80000000)
    values = (vbits - ((vbits >> 31) << 32)).to(torch.int32).view(torch.float32)
    return values, keys & 0xFFFFFFFF


def neighbors_device(coords: torch.Tensor, k: int, n_real=None, block: int = 512):
    """Blocked exact k-NN on the coordinates' device; coords f32[N, 3].

    Per block of ``block`` rows: squared distances |x|^2 + |y|^2 - 2 x.y
    (the product in float32, TF32 off), clamped at 0, self and the columns
    at or past ``n_real`` (trailing padding atoms; default N) set to inf,
    then the k smallest, ties to the lower index (``smallest_k``).
    Unreachable slots (fewer than k candidates) hold index 0 and distance
    0, and so do the rows at or past ``n_real``. The formula loses about
    1e-2 A to float32 cancellation at protein coordinate magnitudes
    (``nmrgnn_tpu/data/device_graph.py:47-49``), so near-ties may order
    differently from ``neighbors_host``."""
    n = coords.shape[0]
    dev = coords.device
    n_real = n if n_real is None else int(n_real)
    cp = coords.to(torch.float32)
    sq = (cp * cp).sum(-1)
    cols = torch.arange(n, device=dev)
    bad_col = cols >= n_real
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        idxs, ds = [], []
        for r0 in range(0, n, block):
            rows = cp[r0:r0 + block]
            d2 = sq[r0:r0 + block, None] + sq[None, :] - 2.0 * (rows @ cp.T)
            d2 = torch.clamp(d2, min=0.0)
            bad = (cols[r0:r0 + rows.shape[0], None] == cols[None, :]) | bad_col[None, :]
            d2 = torch.where(bad, torch.inf, d2)
            v, idx = smallest_k(d2, min(k, n))
            reachable = torch.isfinite(v)
            idxs.append(torch.where(reachable, idx, 0))
            ds.append(torch.where(reachable, torch.sqrt(v), 0.0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    nlist = torch.cat(idxs).to(torch.int32)
    dists = torch.cat(ds)
    if nlist.shape[1] < k:  # fewer atoms than slots: the rest unreachable
        nlist = torch.nn.functional.pad(nlist, (0, k - nlist.shape[1]))
        dists = torch.nn.functional.pad(dists, (0, k - dists.shape[1]))
    real_row = (cols < n_real)[:, None]
    return torch.where(real_row, nlist, 0), torch.where(real_row, dists, 0.0)
