"""MACE's updates, both layers (Linear_up, the first layer's element mix
of A or a later layer's skip, Linear_prod): their least time
(``flops/mace.py`` ``update``) over the device time of the kernels
launched under ``nmrgnn.update``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "update", "nmrgnn.update")
