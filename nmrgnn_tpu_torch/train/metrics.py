"""Name-keyed evaluation metrics (``nmrgnn_tpu/train/metrics.py``).

``type_mask`` resolves an atom-name regex to vocabulary indices; the
metrics are masked RMSD, Pearson r (no variance clip, SURVEY C9) and
counts over ``y[..., 3] = (shift, name_idx, weight)`` labels, each a value
of one batch (the trainer sums moments over an epoch instead).
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List

import torch

from .losses import _divide_no_nan, corr_coeff, label_mask


def type_mask(label_name: str, embeddings: dict, regex: bool = False) -> List[int]:
    """The vocabulary indices of a name, or of the names a regex matches
    from their start; ValueError when the regex matches none."""
    if regex:
        m = re.compile(label_name)
        ln = [v for k, v in embeddings["name"].items() if m.match(k)]
        if not ln:
            raise ValueError("Regular expression did not match any embeddings")
        return ln
    return [embeddings["name"][label_name]]


def name_rmsd(y_true, y_pred, label_idx):
    """Masked RMSD."""
    w = label_mask(y_true, label_idx)
    diff = (y_true[..., 0] - y_pred) ** 2 * w
    return torch.sqrt(_divide_no_nan(torch.sum(diff), torch.sum(w)))


def name_corr(y_true, y_pred, label_idx):
    """Masked Pearson r, no variance clip."""
    w = label_mask(y_true, label_idx)
    return corr_coeff(y_true[..., 0], y_pred, w, clip=False)


def name_count(y_true, y_pred, label_idx):
    """Number of selected labeled atoms."""
    return torch.sum(label_mask(y_true, label_idx))


# The reference model's 15 metrics: masked RMSD and r of the H/N/C/HN/HA
# name groups, r and count of the organic MB / DFT classes.
METRIC_SPECS = (
    ("h_rmsd", name_rmsd, r".*\-H.*"),
    ("n_rmsd", name_rmsd, r".*\-N.*"),
    ("c_rmsd", name_rmsd, r".*\-C.*"),
    ("hn_rmsd", name_rmsd, r".*\-H$"),
    ("ha_rmsd", name_rmsd, r".*\-HA*"),
    ("h_r", name_corr, r".*\-H.*"),
    ("n_r", name_corr, r".*\-N.*"),
    ("c_r", name_corr, r".*\-C.*"),
    ("hn_r", name_corr, r".*\-H$"),
    ("ha_r", name_corr, r".*\-HA.*"),
    ("avg_ha_count", name_count, r".*\-HA.*"),
    ("mb_r", name_corr, r"MB.*"),
    ("avg_mb_count", name_count, r"MB.*"),
    ("dft_r", name_corr, r"DFT.*"),
    ("avg_dft_count", name_count, r"DFT.*"),
)


def build_metric_fns(embeddings: dict) -> Dict[str, Callable]:
    """{name: fn(y_true, y_pred)} of the standard suite against a
    vocabulary; a regex that matches nothing there is skipped."""
    out = {}
    for name, fn, pattern in METRIC_SPECS:
        try:
            idx = tuple(type_mask(pattern, embeddings, regex=True))
        except ValueError:
            continue
        out[name] = (lambda f, i: lambda yt, yp: f(yt, yp, i))(fn, idx)
    return out
