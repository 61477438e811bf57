"""Masked losses keyed by atom-name indices (``nmrgnn_tpu/train/
losses.py``). Labels are ``y[..., 3] = (shift, name_idx, weight)``: an
atom counts iff its weight flag is nonzero and its name index is in the
selected set.

    loss = s * L2_masked + (1 - s) * (1 - pearson_r_masked)

``corr_coeff`` clips the variance product into [0, 1e32] in the loss;
the metric (``clip=False``) does not (SURVEY C9).
"""
from __future__ import annotations

from typing import Sequence

import torch


def _divide_no_nan(num, den):
    """num / den, 0 where den is 0 (and no NaN in either's gradient)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def corr_coeff(x, y, w=None, clip: bool = True):
    """Weighted Pearson correlation."""
    if w is None:
        w = torch.ones_like(x)
    m = torch.sum(w)
    xm = _divide_no_nan(torch.sum(w * x), m)
    ym = _divide_no_nan(torch.sum(w * y), m)
    xm2 = _divide_no_nan(torch.sum(w * x * x), m)
    ym2 = _divide_no_nan(torch.sum(w * y * y), m)
    cov = torch.sum(w * (x - xm) * (y - ym))
    var_prod = (xm2 - xm * xm) * (ym2 - ym * ym)
    if clip:
        var_prod = torch.clamp(var_prod, 0.0, 1e32)
    return _divide_no_nan(cov, m * torch.sqrt(var_prod))


def label_mask(y_true, label_idx: Sequence[int]):
    """f32 mask: the weight flag times the membership of name_idx in
    ``label_idx`` (a sequence of ints, or an int tensor on y's device)."""
    ln = torch.as_tensor(label_idx, dtype=torch.int64, device=y_true.device)
    # a broadcast compare, as the JAX package's: torch.isin waits for the
    # device on CUDA
    member = (y_true[..., 1].to(torch.int64)[..., None] == ln).any(-1)
    return y_true[..., -1] * member.to(torch.float32)


def name_loss(y_true, y_pred, label_idx, s: float = 1.0):
    """NameLoss over all leading axes: y_true f32[..., 3], y_pred f32[...]."""
    w = label_mask(y_true, label_idx)
    x = y_pred
    y = y_true[..., 0]
    l2 = _divide_no_nan(torch.sum(w * (y - x) ** 2), torch.sum(w))
    r = corr_coeff(x, y, w, clip=True)
    return l2 * s + (1.0 - s) * (1.0 - r)
