"""The model's least operations done in the window over the device's peak."""
from portbench.harness.readers import mfu


def read(rec):
    return mfu(rec, "requests")
