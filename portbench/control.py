"""Readings that the limits of ``correct`` are set from, for one cell at
its own size, in one process:

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3 --seconds 3

For each of ``--seeds``, a run's set-up and a short window at the cell's
load, then the numbers its check compares (the program's: the lower
readings). For each of ``--control-seeds`` also the control's numbers:
the reference computed with its products in TF32 in the program's place
(the upper readings). One JSON line each, then the largest program
reading and the smallest control reading of each number.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if sys.path and os.path.abspath(sys.path[0] or ".") == BENCH:
    sys.path[0] = ROOT


def readings(workload: str, seed: int, seconds: float, control: bool, device="cuda:0",
             traffic: dict = None, bench: dict = None) -> dict:
    """The numbers a run of ``workload`` compares, and with ``control`` the
    control's readings, at the cell's size."""
    import torch

    from portbench.run import make_cell

    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cell, driver = make_cell(bench, workload, seed, device, traffic=traffic)
    st = driver.setup(cell)
    driver.window(cell, st, seconds)
    driver.release(st)
    gc.collect()
    out = {"seed": seed, "program": driver.check(cell, st)}
    if control:
        out["control"] = driver.check(cell, st, control=True)
    del st
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    lows, highs = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        r = readings(args.workload, seed, args.seconds, seed in args.control_seeds)
        print(json.dumps(r), flush=True)
        if seed in args.seeds:
            for k, v in r["program"].items():
                lows[k] = max(lows.get(k, 0.0), v)
        for k, v in r.get("control", {}).items():
            highs[k] = min(highs.get(k, float("inf")), v)
    print(json.dumps({"lower": lows, "upper": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
