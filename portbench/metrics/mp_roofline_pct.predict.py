"""The MP layers' least time over the device time of the MP kernels."""
from portbench.harness.readers import roofline


def read(rec):
    return roofline(rec, "requests", "mp", "MP kernels")
