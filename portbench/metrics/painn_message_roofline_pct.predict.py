"""PaiNN's messages, all blocks: their least time (``flops/painn.py``
``message``) over the device time of the kernels launched under
``nmrgnn.message``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "message", "nmrgnn.message")
