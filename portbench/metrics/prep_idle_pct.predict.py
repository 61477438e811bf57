"""The device idle under the host's preparation (permute, plan, h2d), % of the slice."""
from portbench.harness.spans import READ


def read(rec):
    return READ["prep_idle_pct.predict"](rec)
