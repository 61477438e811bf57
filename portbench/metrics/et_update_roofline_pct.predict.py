"""The equivariant transformer's updates, all layers (LayerNorm, the q, k,
v, o and vector projections, vec_dot, the residuals): their least time
(``flops/et.py`` ``update``) over the device time of the kernels launched
under ``nmrgnn.update``."""
from portbench.harness.spans import roofline


def read(rec):
    return roofline(rec, "update", "nmrgnn.update")
