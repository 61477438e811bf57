"""Radial basis expansion of distances (``nmrgnn_tpu/ops/rbf.py``).

Centers are ``linspace(low, high, count)``, gap is ``centers[1] -
centers[0]``, and the expansion is ``exp(-(d - mu)^2 / gap)``: the
division is by the gap, not the gap squared, as in the reference model.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def rbf_centers(low: float, high: float, count: int) -> np.ndarray:
    return np.linspace(low, high, count, dtype=np.float32)


@functools.lru_cache(maxsize=16)
def _centers_on(low: float, high: float, count: int, device: torch.device) -> torch.Tensor:
    """The centers on ``device``, copied once: a copy from host memory each
    forward would make the host wait for the device each time."""
    return torch.as_tensor(rbf_centers(low, high, count), device=device)


def rbf_expand(distances: torch.Tensor, low: float, high: float, count: int) -> torch.Tensor:
    """Expand [...]-shaped distances into [..., count] RBF features."""
    centers = _centers_on(float(low), float(high), int(count), distances.device)
    gap = centers[1] - centers[0]
    d = distances[..., None] - centers
    return torch.exp(-(d * d) / gap)
