"""The number that decides ``correct``: ``peak_gap``, the widest gap
between a served peak and the reference's, over the compared requests, as
a share of the largest reference peak of that request.
"""
from __future__ import annotations

import numpy as np


def peak_gap(served, reference) -> float:
    s = np.asarray(served, np.float64)
    r = np.asarray(reference, np.float64)
    if s.shape != r.shape or not np.all(np.isfinite(s)):
        return float("inf")
    return float(np.max(np.abs(s - r)) / max(np.max(np.abs(r)), 1e-30))
