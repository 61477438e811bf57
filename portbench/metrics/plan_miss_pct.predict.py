"""Plan checks that missed and built a new plan (``nmrgnn.plan.build`` over ``nmrgnn.plan``), %."""
from portbench.harness.spans import READ


def read(rec):
    return READ["plan_miss_pct.predict"](rec)
