"""The MP layers' least time over the device time of the kernels launched under ``nmrgnn.mp``."""
from portbench.harness.spans import READ


def read(rec):
    return READ["attn_roofline_pct.predict"](rec)
