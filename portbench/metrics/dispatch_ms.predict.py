"""Host ms a request enqueuing the forward's launches (``nmrgnn.forward``)."""
from portbench.harness.spans import READ


def read(rec):
    return READ["dispatch_ms.predict"](rec)
