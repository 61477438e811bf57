"""95th percentile of the window's request latencies."""
from portbench.harness.readers import percentile_ms


def read(rec):
    return percentile_ms(rec, 95)
