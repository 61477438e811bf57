"""Median latency of the window's requests, from the call to peaks on the host."""
from portbench.harness.readers import percentile_ms


def read(rec):
    return percentile_ms(rec, 50)
