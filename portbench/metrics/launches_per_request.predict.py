"""Kernel launches in the traced slice, a request."""
from portbench.harness.readers import per_unit


def read(rec):
    return per_unit(rec, "requests")
