"""What the metric files under ``metrics/`` share: each reads the run's
record (``harness/cell.py``) and returns a number, or None where the run
holds nothing for it to read."""
from __future__ import annotations

import statistics

import numpy as np


def _units(rec: dict, kind: str):
    return rec.get("units", {}).get(kind)


def percentile_ms(rec: dict, q: float):
    """The ``q``-th percentile of the window's request latencies, ms."""
    lat = _units(rec, "latencies_s")
    if not lat:
        return None
    if q == 50:
        return statistics.median(lat) * 1e3
    return float(np.percentile(np.asarray(lat), q)) * 1e3


def rate(rec: dict, kind: str):
    """Units a second over the window."""
    n = _units(rec, kind)
    return n / rec["window_s"] if n else None


def idle_pct(rec: dict, kind: str):
    """The device's idle share of the traced slice, %."""
    s = rec.get("slice")
    if not s or _units(rec, kind) is None or s["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["slice_s"])


def per_unit(rec: dict, kind: str):
    """Kernel launches in the traced slice over the units it completed."""
    s = rec.get("slice")
    if not s or _units(rec, kind) is None or s["units"] <= 0:
        return None
    return s["launches"] / s["units"]


def _peak_flops(rec: dict):
    peaks = rec.get("peaks")
    return None if not peaks else peaks["flops"][rec["dtype"]]


def mfu(rec: dict, kind: str):
    """The model's least operations done over the window's seconds, as a
    share of the device's peak, %."""
    peak, r = _peak_flops(rec), rate(rec, kind)
    if peak is None or r is None:
        return None
    work = rec["work"]
    return 100.0 * r * work["forward"] / peak


def roofline(rec: dict, kind: str, part: str, layer: str):
    """The least time of ``part``'s work (``flops/``) over the device time
    of the kernels assigned to ``layer`` in the traced slice, %."""
    s, peak = rec.get("slice"), _peak_flops(rec)
    if not s or peak is None or _units(rec, kind) is None or s["units"] <= 0:
        return None
    busy = s["layer_s"].get(layer, 0.0)
    if busy <= 0:
        return None
    flops, nbytes = rec["work"][part]
    least = max(flops / peak, nbytes / rec["peaks"]["hbm_bytes_per_s"])
    return 100.0 * least * s["units"] / busy
