"""Fragments and their neighbor lists built on the coordinates' device
(``nmrgnn_tpu/data/device_graph.py``): the training input pipeline and
trajectory inference can keep coordinates on the card."""
from __future__ import annotations

import torch

from .neighbors import smallest_k
from .parse import ANGSTROM_TO_NM


def fragment_device(
    coords: torch.Tensor,        # f32[N, 3] (Angstrom)
    seed_indices: torch.Tensor,  # int[S]
    fragment_size: int = 256,
    k: int = 16,
):
    """Spatial-ball fragments around seed atoms, with in-fragment neighbor
    lists: (members i32[S, size] original indices sorted by distance to the
    seed, nlist i32[S, size, k] fragment-local indices, edges f32[S, size,
    k] distances in nm, weight f32[S, size] core/halo mask), size =
    min(fragment_size, N), the contract of the host fragmenter
    (``data/fragment.py``).

    Members: the |s|^2 + |x|^2 - 2 s.x distances to the seed (TF32 off),
    ties to the lower index. Neighbors: exact in-fragment differences (the
    formula loses about 1e-2 A to float32 cancellation at protein
    magnitudes; fragments are small enough for the [S, size, size, 3]
    form), self excluded, ties to the lower index; when size - 1 < k the
    last slots hold index 0 and distance 0. The core weight is 1 on the
    first half of each fragment (at least one atom)."""
    n = coords.shape[0]
    size = min(fragment_size, n)
    seed_indices = torch.as_tensor(seed_indices, device=coords.device).long()
    seeds = coords[seed_indices]                                   # [S, 3]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d2_seed = ((seeds ** 2).sum(-1)[:, None] + (coords ** 2).sum(-1)[None, :]
                   - 2.0 * (seeds @ coords.T))                      # [S, N]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _, members = smallest_k(d2_seed, size)                         # [S, size]
    frag = coords[members]                                         # [S, size, 3]
    diff = frag[:, :, None, :] - frag[:, None, :, :]
    d2 = (diff * diff).sum(-1)
    eye = torch.eye(size, dtype=torch.bool, device=coords.device)
    d2 = torch.where(eye[None], torch.inf, d2)
    kk = min(k, size - 1)
    v, nbr = smallest_k(d2, kk)                                    # [S, size, kk]
    dists = torch.sqrt(torch.clamp(v, min=0.0)) * ANGSTROM_TO_NM
    if kk < k:
        nbr = torch.nn.functional.pad(nbr, (0, k - kk))
        dists = torch.nn.functional.pad(dists, (0, k - kk))
    n_core = max(1, int(size * 0.5))
    weight = (torch.arange(size, device=coords.device) < n_core).to(torch.float32)
    weight = weight.expand(seed_indices.shape[0], size).contiguous()
    return members.to(torch.int32), nbr.to(torch.int32), dists, weight

