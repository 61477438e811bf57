"""String-keyed activations (``nmrgnn_tpu/ops/activations.py``).

softplus is written as ``max(x, 0) + log1p(exp(-|x|))``, the form of
``jax.nn.softplus`` (``logaddexp(x, 0)``), not torch's thresholded form
(which returns ``x`` itself above 20). The CUDA kernels use the same
expression (``csrc/banded.cu``, ``activate``). ``silu`` (x sigmoid(x),
the PaiNN family's) has no kernel code: only plain PyTorch takes it.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# Codes the CUDA kernels take for an activation (csrc/banded.cu, enum Act).
ACTIVATION_CODES = {None: 0, "linear": 0, "relu": 1, "softplus": 2, "tanh": 3}


def activation_code(name: Optional[str]) -> int:
    """The CUDA kernels' code for activation ``name``; raises for one they
    do not take."""
    act = ACTIVATION_CODES.get(name)
    if act is None:
        raise ValueError(f"unknown activation {name!r}")
    return act


class _Softplus(torch.autograd.Function):
    """softplus with the gradient sigmoid(x), as ``jax.nn.softplus`` has it
    (0.5 at 0, where the gradient of the expression itself would be
    clamp's 1 plus abs's 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Softplus.apply(x)
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)  # gradient 0 at 0, as jax.nn.relu


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTIVATIONS = {
    None: _identity,
    "linear": _identity,
    "relu": relu,
    "softplus": softplus,
    "tanh": torch.tanh,
    "silu": torch.nn.functional.silu,
}


def get_activation(name: Optional[str]) -> Callable:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(k for k in _ACTIVATIONS if k)}"
        ) from None
