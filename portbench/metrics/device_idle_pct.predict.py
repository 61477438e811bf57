"""The device's idle share of the traced slice (1 - union of device activity / slice)."""
from portbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec, "requests")
