"""Chebyshev compression of the edge stage (``nmrgnn_tpu/ops/edgefn.py``),
the edge stage of the "fast" serving precision.

The whole edge stage, RBF expansion then the EdgeFC MLP, maps a scalar
distance to E channels, e(d) = EdgeFC(RBF(d)). Serving fits it once per
model with one Chebyshev polynomial per channel on [d_lo, d_hi] (host
numpy, float64, ``chebfit``) and evaluates it with an FMA-only recurrence
inside the band build (``ops/banded.build_band_poly``). Past ``d_hi``
every RBF bump has decayed, so e is constant there and distances are
clamped into the fitted domain.

The fit and its numpy evaluation are the JAX package's, line for line, so
the same parameters give bitwise the same coefficients.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EdgeCheb(NamedTuple):
    """Chebyshev model of the edge stage: coefficients in the Chebyshev
    basis on [d_lo, d_hi]; evaluate with clamped input."""

    coeffs: np.ndarray  # f32[degree + 1, E]
    d_lo: float
    d_hi: float

    @property
    def degree(self) -> int:
        return self.coeffs.shape[0] - 1


def exact_edge_fn(d: np.ndarray, edge_fc_params, *, rbf_low: float,
                  rbf_high: float, rbf_count: int, activation: str) -> np.ndarray:
    """The exact edge stage on the host (numpy float64): RBF, then EdgeFC.
    Returns [len(d), E], without the padding mask."""
    act = {
        "softplus": lambda x: np.logaddexp(0.0, x),
        "relu": lambda x: np.maximum(x, 0.0),
        "tanh": np.tanh,
        "linear": lambda x: x,
        None: lambda x: x,
    }[activation]
    centers = np.linspace(rbf_low, rbf_high, rbf_count, dtype=np.float32)
    gap = float(centers[1] - centers[0])
    x = np.exp(-((d[:, None].astype(np.float64) - centers) ** 2) / gap)
    for i, p in enumerate(edge_fc_params):
        k = np.asarray(p["kernel"], np.float64)
        x = x @ k
        if "bias" in p:
            x = x + np.asarray(p["bias"], np.float64)
        if i < len(edge_fc_params) - 1:
            x = act(x)
    return x


def fit_edge_chebyshev(
    edge_fc_params,
    *,
    rbf_low: float,
    rbf_high: float,
    rbf_count: int,
    activation: str = "softplus",
    degree: int = 96,
    d_lo: float = 0.0,
    d_hi: float = None,
    n_samples: int = 8192,
) -> EdgeCheb:
    """Fit e(d) on [d_lo, d_hi]. ``edge_fc_params`` holds numpy arrays or
    tensors (read on the host). ``d_hi`` defaults to the distance past
    which every RBF center has decayed below ~1e-7 (sqrt(16 * gap) past
    rbf_high), where e is constant, so clamping larger d is exact."""
    edge_fc_params = [
        {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
         for k, v in p.items()}
        for p in edge_fc_params
    ]
    if d_hi is None:
        gap = (rbf_high - rbf_low) / (rbf_count - 1)
        d_hi = rbf_high + float(np.sqrt(16.0 * gap))
    d = np.linspace(d_lo, d_hi, n_samples)
    y = exact_edge_fn(
        d, edge_fc_params,
        rbf_low=rbf_low, rbf_high=rbf_high, rbf_count=rbf_count,
        activation=activation,
    )
    x = 2.0 * (d - d_lo) / (d_hi - d_lo) - 1.0  # chebfit wants x in [-1, 1]
    coeffs = np.polynomial.chebyshev.chebfit(x, y, degree)
    return EdgeCheb(
        coeffs=np.ascontiguousarray(coeffs, np.float32),
        d_lo=float(d_lo), d_hi=float(d_hi),
    )


def eval_edge_chebyshev(cheb: EdgeCheb, d: np.ndarray) -> np.ndarray:
    """Reference evaluation (numpy float64), clamp included; for tests."""
    x = np.clip(
        2.0 * (np.clip(d, cheb.d_lo, cheb.d_hi) - cheb.d_lo)
        / (cheb.d_hi - cheb.d_lo) - 1.0,
        -1.0, 1.0,
    )
    return np.polynomial.chebyshev.chebval(x, cheb.coeffs.astype(np.float64)).T


def cheb_x(cheb: EdgeCheb, d: torch.Tensor) -> torch.Tensor:
    """The clamped distance mapped onto [-1, 1] in float32, rounded at the
    same steps as the band-build kernels (``csrc/poly.cu``):
    ((clamp(d) - d_lo) * 2) / (d_hi - d_lo) - 1, each constant in f32."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=d.device)  # noqa: E731
    lo, hi, span = f32(cheb.d_lo), f32(cheb.d_hi), f32(cheb.d_hi - cheb.d_lo)
    return 2.0 * (torch.minimum(torch.maximum(d, lo), hi) - lo) / span - 1.0


def eval_edge_chebyshev_device(cheb: EdgeCheb, d: torch.Tensor) -> torch.Tensor:
    """Evaluation on tensors by the Clenshaw recurrence (FMA-only, no
    transcendentals), the twin of the JAX package's device evaluation.
    Returns e[..., E] in float32; the caller applies the padding mask."""
    x = torch.clamp(cheb_x(cheb, d), -1.0, 1.0)
    c = torch.as_tensor(cheb.coeffs, device=d.device)  # [degree + 1, E]
    b1 = torch.zeros(x.shape + (c.shape[1],), dtype=x.dtype, device=d.device)
    b2 = torch.zeros_like(b1)
    x2 = (2.0 * x)[..., None]
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k] + x2 * b1 - b2, b1
    return c[0] + x[..., None] * b1 - b2
