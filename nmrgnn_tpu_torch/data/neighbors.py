"""Exact k-nearest-neighbor lists on the host (``nmrgnn_tpu/data/
neighbors.py:28-53``): the native cell list (``nmrgnn_tpu_torch/native.py``)
when its library builds and loads, scipy's cKDTree otherwise, the JAX
package's rule, so both packages build the same graphs (tied neighbors in
the same slots, distances to the bit).

Returns (nlist i32[N, K], dists f32[N, K]) sorted by increasing distance,
self excluded, in the units of ``coords``. Slots beyond the true neighbor
count (N - 1 < K) hold index 0 and distance 0.
"""
from __future__ import annotations

import numpy as np


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
