"""RBF + EdgeFC's least time over the device time of the edge-stage kernels."""
from portbench.harness.readers import roofline


def read(rec):
    return roofline(rec, "requests", "edge", "edge stage")
