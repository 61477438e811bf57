"""MACE's convolutions, both layers (the radial MLPs, the tensor products
and slot sums over every block, the linear after each): their least time
(``flops/mace.py`` ``conv``) over the device time of the kernels launched
under ``nmrgnn.conv``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "conv", "nmrgnn.conv")
