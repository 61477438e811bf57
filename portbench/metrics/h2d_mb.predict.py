"""MB (1e6 bytes) a request copies host to device under ``nmrgnn.h2d``."""
from portbench.harness.spans import READ


def read(rec):
    return READ["h2d_mb.predict"](rec)
