"""Run one cell of the benchmark of ``nmrgnn_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is a ``workloads`` entry of
``BENCHMARK.json``: its configuration is ``portbench/configs/<config>.json``
and its traffic ``portbench/traffic/<traffic>.json``, whose ``driver``
names ``portbench/drivers/<driver>.py``. A run sets up (weights and
inputs from the seed, every shape warmed), measures for ``--seconds``,
then checks a sample of what the window produced against the plain
reference (``portbench/reference/``), each number against
``portbench/limits/<cell>.json``. ``--trace 1`` also profiles a slice of
the traffic after the window and reports the per-layer metrics.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; 1: its per-layer ones, each ``metrics/<name>.py``),
``device``, with ``--trace 1`` ``breakdown``, ``phases`` (the host
seconds of set-up's steps and of the check), and last ``check``: each
number compared beside its limit, which also end standard error.
Exits non-zero without a CUDA device, or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if sys.path and os.path.abspath(sys.path[0] or ".") == BENCH:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "portbench",
                                                           "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "portbench", "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "nmrgnn_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def metric_specs(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    (``trace`` False) or its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if "workloads" not in m or workload in m["workloads"]]


def peaks_of(kind: str):
    """The table of ``peaks/*.json`` whose ``match`` is in the device's name."""
    for path in sorted(glob.glob(os.path.join(BENCH, "peaks", "*.json"))):
        with open(path) as f:
            table = json.load(f)
        if table["match"] in kind:
            return table
    return None


def make_cell(bench: dict, workload: str, seed: int, device, traffic: dict = None):
    """The Cell of ``workload`` (its configuration and traffic files, the
    parameters of ``traffic`` over the file's) and its driver module; on
    a CUDA device the kernels are built first (a later run finds them)."""
    import torch

    from portbench.harness.cell import Cell, load_json

    w = find_workload(bench, workload)
    cell = Cell(name=workload, root=BENCH, config=load_json(BENCH, "configs", f"{w['config']}.json"),
                traffic={**load_json(BENCH, "traffic", f"{w['traffic']}.json"), **(traffic or {})},
                seed=seed, device=torch.device(device))
    cell.mark("start")
    if cell.device.type == "cuda":
        from nmrgnn_tpu_torch.ops import _cuda

        torch.cuda.init()
        cell.mark("cuda")
        _cuda.build()  # every kernel source at once, one nvcc each
        cell.mark("build")
    return cell, importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
        t0: float = None, traffic: dict = None) -> dict:
    """One run of ``workload`` on ``device``; returns the result object.
    The CPU rehearses it through the program's plain paths, at the sizes
    ``traffic`` puts over the traffic file's."""
    import torch

    from portbench.harness.cell import load_json, load_module
    from portbench.harness.trace import Slice

    t0 = T0 if t0 is None else t0
    started = time.perf_counter() - t0
    cell, driver = make_cell(bench, workload, seed, device, traffic)
    device = cell.device
    rec = cell.record
    rec["phases"]["start"] = started
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    st = driver.setup(cell)
    cell.mark("setup")
    slice_ = Slice(BENCH) if trace else None
    driver.window(cell, st, seconds, slice_, cell.traffic.get("trace_seconds", 0.0))
    rec["setup_s"] = rec["t_window"] - t0
    rec["peaks"] = peaks_of(kind)
    fast = cell.traffic.get("precision") == "fast" or cell.config["compute_dtype"] == "bfloat16"
    rec["dtype"] = "bfloat16" if fast else "float32"
    if slice_ is not None:
        rec["slice"] = slice_.summary
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    if slice_ is not None:
        dev["busy_s"] = slice_.summary["busy_s"]
        dev["window_s"] = slice_.summary["slice_s"]
    driver.release(st)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cell.mark("window")
    numbers = driver.check(cell, st)
    cell.mark("check")
    limits = load_json(BENCH, "limits", f"{workload}.json")
    check = {k: {"value": float(v), "limit": limits[k]} for k, v in numbers.items()}
    over = [k for k, c in check.items() if not c["value"] <= c["limit"]]
    metrics = {}
    for spec in metric_specs(bench, workload, trace):
        mod = load_module(os.path.join(BENCH, "metrics", f"{spec['name']}.py"),
                          "portbench_metric_" + spec["name"].replace(".", "_"))
        value = mod.read(rec)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    result = {"correct": not over, "attempted": int(rec.get("attempted", 0)),
              "failed": len(over), "metrics": metrics, "device": dev}
    if slice_ is not None:
        result["breakdown"] = {"device_ops": slice_.summary["device_ops"],
                               "idle_gaps": slice_.summary["idle_gaps"]}
    rec.pop("_mark")
    result["phases"] = rec["phases"]
    result["detail"] = rec.get("detail", {})
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = find_workload(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print("phases " + " ".join(f"{k} {v:.3f}" for k, v in result["phases"].items()),
          file=sys.stderr)
    print("detail " + json.dumps(result.pop("detail")), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
