"""The program's spans in a traced slice (``harness/spans.py``) on a small
recorded trace: two requests on the main thread, a graph build on a
second, H2D copies with and without their byte counts, and a kernel that
runs after the span that launched it has closed."""
import json
import os

import pytest

from portbench.harness import spans, trace
from portbench.harness.cell import load_module
from portbench.run import BENCH
from portbench.tests.tiny import bench

HERE = os.path.dirname(os.path.abspath(__file__))
US = 1e-6


def _events(name):
    with open(os.path.join(HERE, "data", name)) as f:
        return json.load(f)["traceEvents"]


# slice 0-1000 us; device busy 60-70, 150-160, 312-340, 370-420, 460-520,
# 620-640, 880-885. Per name: count, host, self, idle (us), kernel device
# us launched directly under it, HtoD bytes
WANT = {
    "nmrgnn.predict": (2, 890, 20 + 70, 627 + 90, 0, None),
    "nmrgnn.permute": (1, 90, 90, 80, 0, None),  # its copy reports no bytes
    "nmrgnn.plan": (2, 120, 40 + 20, 100 + 20, 0, None),
    "nmrgnn.plan.build": (1, 60, 60, 60, 0, None),
    "nmrgnn.h2d": (1, 50, 50, 22, 0, 6000),
    "nmrgnn.forward": (1, 150, 100, 60, 50, None),
    "nmrgnn.mp": (1, 50, 50, 30, 60, None),  # its kernel runs 460-520, after the span
    "nmrgnn.readback": (1, 390, 390, 345, 0, None),  # a DtoH copy is not H2D
    "nmrgnn.build": (1, 100, 100, 80, 20, None),  # the one starting at 1100 is past the slice
}


def test_summary_of_the_program_spans():
    got = spans.summarize_spans(_events("trace_spans.json"))
    assert sorted(got) == sorted(WANT)
    for name, (count, host, self_, idle, device, h2d) in WANT.items():
        row = got[name]
        assert row["count"] == count, name
        assert row["host_s"] == pytest.approx(host * US), name
        assert row["self_s"] == pytest.approx(self_ * US), name
        assert row["idle_s"] == pytest.approx(idle * US), name
        assert row["device_s"] == pytest.approx(device * US), name
        assert row["h2d_bytes"] == h2d, name


def _rec(units=2, events="trace_spans.json"):
    ev = _events(events)
    s = trace.summarize(ev, trace.kernel_layers(BENCH))
    s["spans"] = spans.summarize_spans(ev)
    s["units"] = units
    work = {"edge": (0.5e6, 1e3), "mp": (1.0e6, 2.0e3), "readout": (1e6, 1e3), "forward": 2.5e6}
    return {"slice": s, "units": {"requests": 10, "latencies_s": [0.01] * 10}, "window_s": 1.0,
            "work": work, "dtype": "float32",
            "peaks": {"flops": {"float32": 67e12}, "hbm_bytes_per_s": 3.35e12}}


def test_readings_of_the_recorded_slice():
    got = spans.readings(_rec())
    assert set(got) == set(spans.READ)
    assert got["permute_ms.predict"] == pytest.approx(90 * US * 1e3 / 2)
    assert got["plan_ms.predict"] == pytest.approx(120 * US * 1e3 / 2)
    assert got["plan_miss_pct.predict"] == pytest.approx(50.0)
    assert got["h2d_mb.predict"] == pytest.approx(6000 * 1e-6 / 2)
    assert got["dispatch_ms.predict"] == pytest.approx(150 * US * 1e3 / 2)
    assert got["prep_idle_pct.predict"] == pytest.approx(100 * (80 + 120 + 22) / 1000)
    # 2 requests of 1 MFLOP of MP work at 67 TFLOP/s over 60 us of kernels
    assert got["attn_roofline_pct.predict"] == pytest.approx(100 * 2 * 1.0e6 / 67e12 / 60e-6)


def test_idle_gaps_name_the_program_spans():
    gaps = dict(trace.summarize(_events("trace_spans.json"), trace.kernel_layers(BENCH))
                ["idle_gaps"])
    assert "portbench.predict" not in gaps
    assert gaps["nmrgnn.readback"] == pytest.approx((100 + 240) * US)
    assert gaps["nmrgnn.plan.build"] == pytest.approx(152 * US)
    assert gaps["nmrgnn.predict"] == pytest.approx(115 * US)


def test_readings_find_nothing_without_program_spans():
    # the benchmark's own recorded slice, whose program has no spans
    rec = _rec(events="trace_small.json")
    assert rec["slice"]["spans"] == {}
    assert all(v is None for v in spans.readings(rec).values())
    # nor without a slice, nor where the slice completed no request
    assert all(v is None for v in spans.readings({"units": {}}).values())
    assert all(v is None for v in spans.readings(_rec(units=0)).values())
    # no peaks: no roofline, the rest still read
    rec = _rec()
    rec["peaks"] = None
    got = spans.readings(rec)
    assert got["attn_roofline_pct.predict"] is None and got["plan_miss_pct.predict"] == 50.0


@pytest.mark.parametrize("name", sorted(spans.READ))
def test_each_span_reading_is_a_metric_file_and_a_per_layer_entry(name):
    mod = load_module(os.path.join(BENCH, "metrics", f"{name}.py"), "m_" + name.replace(".", "_"))
    rec = _rec()
    assert mod.read(rec) is not None and mod.read(rec) == spans.READ[name](rec)
    spec = {m["name"]: m for m in bench()["per_layer"]}[name]
    assert spec["moves"] == "predict_ms_p50" and spec["workloads"]


@pytest.mark.parametrize("cell", ["baseline-predict-44676", "amp-predict-44676"])
def test_span_readings_tool_on_a_tiny_cell(cell):
    """``tools/span_readings.py`` rehearsed on the CPU: the program's spans
    read from a traced run; no device, so no copies and no kernels."""
    from portbench.run import ROOT
    from portbench.tests.tiny import SEED, TINY

    tool = load_module(os.path.join(ROOT, "tools", "span_readings.py"), "span_readings_tool")
    out = tool.span_run(ROOT, cell, SEED, 1.0, device="cpu", traffic=TINY[cell])
    assert out["result"]["correct"] and out["requests"] > 0
    got = out["readings"]
    for name in ("permute_ms.predict", "plan_ms.predict", "dispatch_ms.predict",
                 "prep_idle_pct.predict"):
        assert got[name] > 0, name
    assert got["plan_miss_pct.predict"] is not None
    assert got["h2d_mb.predict"] is None and got["attn_roofline_pct.predict"] is None
    assert out["spans"]["nmrgnn.predict"]["count"] == out["requests"]
    assert out["predict_cover_pct"] > 90
    assert out["idle_under_benchmark_span_pct"] == 0.0
