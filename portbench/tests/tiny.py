"""Tiny sizes at which the cells rehearse on the CPU: the traffic files'
parameters that these replace."""
import json
import os

from portbench import run as bench_run

TINY = {
    "baseline-predict-44676": dict(atoms=100, grid=[2, 1, 1], frames=4, warmup=1, compare=4,
                                   trace_seconds=0.3),
    "amp-predict-44676": dict(atoms=100, grid=[2, 1, 1], frames=4, warmup=1, compare=4,
                              trace_seconds=0.3),
}
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def bench() -> dict:
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def rehearse(cell: str, seconds: float = 2.0, trace: bool = False, seed: int = SEED) -> dict:
    """One run of ``cell`` on the CPU at its tiny size."""
    return bench_run.run(bench(), cell, seed, seconds, trace, "cpu", traffic=TINY[cell])
