"""Tiny sizes at which the cells rehearse on the CPU: ``tiny/<cell>.json``
holds the traffic file's parameters that replace the cell's own."""
import glob
import json
import os

from portbench import run as bench_run

TINY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


def tiny_size(cell: str) -> dict:
    """The parameters of ``tiny/<cell>.json``."""
    path = os.path.join(TINY_DIR, f"{cell}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"cell {cell!r} has no tiny size: add {path}")
    with open(path) as f:
        return json.load(f)


TINY = {c: tiny_size(c) for c in sorted(os.path.splitext(os.path.basename(p))[0]
                                          for p in glob.glob(os.path.join(TINY_DIR, "*.json")))}
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def bench() -> dict:
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def rehearse(cell: str, seconds: float = 2.0, trace: bool = False, seed: int = SEED) -> dict:
    """One run of ``cell`` on the CPU at its tiny size."""
    return bench_run.run(bench(), cell, seed, seconds, trace, "cpu", traffic=tiny_size(cell))
