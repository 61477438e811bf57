"""MACE's symmetric contractions, both layers (each element's W U folded,
then the chain of contractions of A): their least time (``flops/mace.py``
``product``) over the device time of the kernels launched under
``nmrgnn.product``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "product", "nmrgnn.product")
