"""Host ms a request in the program's RCM permutation (its ``nmrgnn.permute`` spans)."""
from portbench.harness.spans import READ


def read(rec):
    return READ["permute_ms.predict"](rec)
