"""PaiNN's filter (geometry, Bessel basis, cutoff, filter Dense): its least
time (``flops/painn.py`` ``filter``) over the device time of the kernels
launched under ``nmrgnn.filter``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "filter", "nmrgnn.filter")
