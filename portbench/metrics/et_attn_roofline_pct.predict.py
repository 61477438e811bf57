"""The equivariant transformer's attention stages, all layers (edge
filters, logits, the scalar and vector sums, the self terms): their least
time (``flops/et.py`` ``attn``) over the device time of the kernels
launched under ``nmrgnn.attn``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "attn", "nmrgnn.attn")
