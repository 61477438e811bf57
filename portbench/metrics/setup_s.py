"""Everything before the window: start-up, inputs, weights, warm-up (and,
on a checkout's first run, the kernels' build)."""


def read(rec):
    return rec.get("setup_s")
