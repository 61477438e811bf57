"""Each cell rehearsed on the CPU at a tiny size through the program's
plain paths: a whole run, its result line and its check."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run as bench_run
from portbench.harness.spans import READ
from portbench.tests.tiny import TINY, bench, rehearse, tiny_size

CELLS = sorted(TINY)


def test_every_cell_of_the_benchmark_has_a_tiny_size():
    for w in bench()["workloads"]:
        tiny_size(w["name"])  # raises, naming the cell, where it has no file
    assert sorted(w["name"] for w in bench()["workloads"]) == CELLS


def test_a_cell_without_a_tiny_size_fails_naming_it():
    with pytest.raises(FileNotFoundError, match="'no-such-cell' has no tiny size"):
        tiny_size("no-such-cell")
    assert tiny_size("baseline-predict-44676") == TINY["baseline-predict-44676"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_correct_with_its_end_to_end_metrics(cell):
    out = rehearse(cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in bench_run.metric_specs(bench(), cell, False)}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "check"
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_reports_per_layer_metrics_and_a_breakdown(cell):
    out = rehearse(cell, trace=True)
    assert out["correct"], out["check"]
    names = {m["name"] for m in bench_run.metric_specs(bench(), cell, True)}
    # the CPU has no peaks and no device time: rooflines and mfu stay silent
    assert set(out["metrics"]) <= names
    assert {n for n in names if n.startswith("device_idle_pct")} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] >= 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    # the program's spans: no copies on the CPU, and no peaks for a roofline
    host = {n for n in names & set(READ) if not n.startswith(("h2d_mb", "attn_roofline"))}
    assert host and host <= set(out["metrics"])
    assert all(out["metrics"][n]["value"] > 0 for n in host if "_ms." in n)


def test_same_seed_same_inputs():
    import numpy as np
    import torch

    from portbench.drivers import predict_loop
    from portbench.harness.cell import Cell, load_json

    def cell(seed):
        return Cell(name="t", root=bench_run.BENCH, seed=seed, device=torch.device("cpu"),
                    config=load_json(bench_run.BENCH, "configs", "nmrgnn-baseline.json"),
                    traffic={**load_json(bench_run.BENCH, "traffic", "predict-44676.json"),
                             **TINY["baseline-predict-44676"]})

    a, b, c = (predict_loop.setup(cell(s)) for s in (2 ** 31 + 5, 2 ** 31 + 5, 2 ** 31 + 6))
    assert torch.equal(a.params["mp"][0]["w"], b.params["mp"][0]["w"])
    assert not torch.equal(a.params["mp"][0]["w"], c.params["mp"][0]["w"])
    # the requests are the traffic's, whatever the run's seed
    for fa, fc in zip(a.frames, c.frames):
        assert all(np.array_equal(x, y) for x, y in zip(fa, fc))
    assert not np.array_equal(a.frames[0][2], a.frames[1][2])


def test_requests_walk_the_frames_forward_and_back():
    from portbench.drivers.predict_loop import frame_of

    assert [frame_of(i, 4) for i in range(9)] == [0, 1, 2, 3, 2, 1, 0, 1, 2]
    assert [frame_of(i, 1) for i in range(3)] == [0, 0, 0]


def test_a_rehearsal_loads_no_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.tiny import rehearse, TINY\n"
        "for c in sorted(TINY): rehearse(c)\n"
        "from portbench.run import forbidden_modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(forbidden_modules())\n" % bench_run.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    top, found = [json.loads(line.replace("'", '"')) for line in out.stdout.splitlines()[-2:]]
    assert "nmrgnn_tpu_torch" in top
    assert found == []
    assert not {"jax", "jaxlib", "flax", "nmrgnn_tpu"} & set(top)


def test_the_command_refuses_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(bench_run.BENCH, "run.py"), "--workload",
                          "baseline-predict-44676", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=bench_run.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_command_fails_where_only_the_benchmark_is(tmp_path):
    import shutil

    shutil.copytree(bench_run.BENCH, tmp_path / "portbench")
    shutil.copy(os.path.join(bench_run.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "baseline-predict-44676", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_at_a_tiny_size_on_the_card(cell, cuda):
    import time

    out = bench_run.run(bench(), cell, 2 ** 31 + 99, 1.0, True, cuda, t0=time.perf_counter(),
                        traffic=TINY[cell])
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    names = {m["name"] for m in bench_run.metric_specs(bench(), cell, True)}
    assert {n for n in names if n.startswith("mfu")} <= set(out["metrics"])
