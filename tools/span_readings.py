#!/usr/bin/env python3
"""Run one traced cell of the benchmark with the program's spans read from
its slice, and print the span readings beside the run's own result.

    python3 tools/span_readings.py --workload CELL --seed N [--seconds 30]
        [--tree DIR] [--out FILE]

DIR is the root of the checkout whose program and benchmark run (default:
this one); the spans are read with this checkout's
``portbench/harness/spans.py``, which DIR need not have, so run it once per
tree, in turns, in one call to compare two checkouts. The run is
``portbench/run.py --trace 1``'s, on the first CUDA device, with the
slice's summary given the spans (``summarize_spans``): the hook that
``Slice.end`` lacks. Prints one JSON object (also written to FILE): the
run's result line, the slice's seconds, requests and milliseconds a
request, the spans' summary, ``readings``, the share of
``nmrgnn.predict``'s host time that its child spans cover, and the share
of the slice's device idle time that the breakdown puts under the
benchmark's own ``portbench.predict`` span.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def span_run(tree: str, workload: str, seed: int, seconds: float, device: str = "cuda:0",
             traffic: dict = None) -> dict:
    """One traced run of ``workload`` from the checkout at ``tree`` (its
    ``portbench`` first on ``sys.path``); ``traffic`` as ``run.run``'s."""
    if tree not in sys.path:
        sys.path.insert(0, tree)
    path = os.path.join(HERE, "portbench", "harness", "spans.py")
    spec = importlib.util.spec_from_file_location("span_readings_spans", path)
    spans = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(spans)
    from portbench import run as bench_run
    from portbench.harness import trace

    base_summarize, base_make_cell, cells = trace.summarize, bench_run.make_cell, []

    def summarize(events, layers):
        return {**base_summarize(events, layers), "spans": spans.summarize_spans(events)}

    def make_cell(*args, **kw):
        cell, driver = base_make_cell(*args, **kw)
        cells.append(cell)
        return cell, driver

    with open(os.path.join(tree, "BENCHMARK.json")) as f:
        bench = json.load(f)
    trace.summarize, bench_run.make_cell = summarize, make_cell
    try:
        result = bench_run.run(bench, workload, seed, seconds, True, device, traffic=traffic)
    finally:
        trace.summarize, bench_run.make_cell = base_summarize, base_make_cell
    rec = cells[-1].record
    s = rec["slice"]
    predict = s["spans"].get("nmrgnn.predict")
    idle = s["slice_s"] - s["busy_s"]
    under = dict(result["breakdown"]["idle_gaps"]).get("portbench.predict", 0.0)
    return {
        "tree": tree, "workload": workload, "seed": seed, "result": result,
        "slice_s": s["slice_s"], "requests": s["units"],
        "slice_ms_per_request": 1e3 * s["slice_s"] / s["units"] if s["units"] else None,
        "spans": s["spans"], "readings": spans.readings(rec),
        "predict_cover_pct": (100.0 * (1.0 - predict["self_s"] / predict["host_s"])
                              if predict else None),
        "idle_under_benchmark_span_pct": 100.0 * under / idle if idle > 0 else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("span_readings: needs a CUDA device")
    out = span_run(os.path.abspath(args.tree), args.workload, args.seed, args.seconds)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
