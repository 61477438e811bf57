"""Host ms a request in the plan's check and, on a miss, its build (``nmrgnn.plan``)."""
from portbench.harness.spans import READ


def read(rec):
    return READ["plan_ms.predict"](rec)
