"""PaiNN's updates, all blocks: their least time (``flops/painn.py``
``update``) over the device time of the kernels launched under
``nmrgnn.update``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "update", "nmrgnn.update")
