"""The traced slice's reading (``harness/trace.py``) and each per-layer
metric reader on a small recorded profiler trace."""
import json
import os

import pytest

from portbench.harness import trace
from portbench.harness.cell import load_module
from portbench.run import BENCH

HERE = os.path.dirname(os.path.abspath(__file__))


def _events():
    with open(os.path.join(HERE, "data", "trace_small.json")) as f:
        return json.load(f)["traceEvents"]


def _read(name, rec):
    return load_module(os.path.join(BENCH, "metrics", f"{name}.py"), "m_" + name.replace(".", "_")).read(rec)


def test_summary_of_the_recorded_slice():
    s = trace.summarize(_events(), trace.kernel_layers(BENCH))
    # slice 0-1000 us; kernels 100-300 (mp), 250-400 (edge, overlapping), 600-700
    # (mp), a copy 800-850; a kernel outside the slice is left out
    assert s["slice_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((300 + 100 + 50) * 1e-6)
    assert s["launches"] == 3
    assert s["layer_s"]["MP kernels"] == pytest.approx(300e-6)
    assert s["layer_s"]["edge stage"] == pytest.approx(150e-6)
    assert s["device_ops"][0][0].startswith("void mp_banded_kernel")
    gaps = dict(s["idle_gaps"])
    # idle: 0-100 and 400-600 under aten::copy_, 700-800 under cudaLaunchKernel,
    # 850-1000 under no operation
    assert gaps["aten::copy_"] == pytest.approx(300e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(100e-6)
    assert gaps["(no host operation)"] == pytest.approx(150e-6)


def _rec(units):
    s = trace.summarize(_events(), trace.kernel_layers(BENCH))
    s["units"] = 2
    work = {"edge": (0.5e9, 1e6), "mp": (10.05e9, 1e6), "readout": (1e9, 1e6),
            "forward": 11.55e9}
    return {"slice": s, "units": units, "window_s": 10.0, "work": work, "dtype": "float32",
            "peaks": {"flops": {"float32": 67e12}, "hbm_bytes_per_s": 3.35e12}}


def test_readers_on_the_recorded_slice():
    rec = _rec({"requests": 100, "latencies_s": [0.01 * (i + 1) for i in range(100)]})
    assert _read("device_idle_pct.predict", rec) == pytest.approx(55.0)
    assert _read("launches_per_request.predict", rec) == pytest.approx(1.5)
    # 2 requests in the slice, each 10.05 GFLOP of MP work at 67 TFLOP/s
    assert _read("mp_roofline_pct.predict", rec) == pytest.approx(
        100 * 2 * 10.05e9 / 67e12 / 300e-6)
    assert _read("edge_roofline_pct.predict", rec) == pytest.approx(
        100 * 2 * 0.5e9 / 67e12 / 150e-6)
    assert _read("mfu.predict", rec) == pytest.approx(100 * 10 * 11.55e9 / 67e12)
    assert _read("predict_ms_p50", rec) == pytest.approx(505.0)
    assert _read("predict_ms_p95", rec) == pytest.approx(950.5)


def test_readers_find_nothing_without_a_slice_or_peaks():
    rec = _rec({"requests": 50, "latencies_s": [0.02] * 50})
    rec.pop("slice")
    rec["peaks"] = None
    assert _read("device_idle_pct.predict", rec) is None
    assert _read("launches_per_request.predict", rec) is None
    assert _read("mp_roofline_pct.predict", rec) is None
    assert _read("mfu.predict", rec) is None
    assert _read("predict_ms_p50", rec) == pytest.approx(20.0)
    # nor without requests
    assert _read("predict_ms_p50", _rec({"requests": 0, "latencies_s": []})) is None
