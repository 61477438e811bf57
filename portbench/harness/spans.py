"""The program's own spans in the traced slice, and the per-layer readings
taken from them.

The program marks its steps with ``torch.profiler.record_function`` spans
named ``nmrgnn.*`` (``nmrgnn_tpu_torch/utils/profiling.py``): they lie in
the slice's Chrome trace on the same clock as the kernels and copies.
``summarize_spans(events)`` gives, for each such name with a span that
starts inside the slice:

  count       its spans
  host_s      their host seconds
  self_s      host_s less the part of each span that its child
              ``nmrgnn.*`` spans on the same thread cover
  idle_s      the device's idle seconds within the spans (the slice's
              idle intervals intersected with each span's interval)
  device_s    device seconds of the kernels launched under them
  h2d_bytes   bytes of the host-to-device copies launched under them, or
              None where no such copy reported its bytes

A kernel or copy is launched under the innermost ``nmrgnn.*`` span that
encloses, on the same process and thread, the runtime call with the same
``args.correlation``; when the device ran it does not matter.

``Slice.end`` (``trace.py``) stores that summary under the slice's
``spans``; ``READ`` turns a run's record into the per-layer readings of a
predict cell, one ``metrics/<name>.py`` each, and ``readings(rec)`` gives
them all.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from portbench.harness.trace import DEVICE_CATS, SLICE_SPAN, _union

PREFIX = "nmrgnn."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
US = 1e-6


def _idle_before(busy, t0: float, t1: float):
    """f(x): the device's idle microseconds in [t0, x], given ``busy``, the
    merged intervals of its activity in the slice [t0, t1]."""
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    if not gaps:
        return lambda x: np.zeros(np.shape(x))
    starts = np.asarray([a for a, _ in gaps])
    lengths = np.asarray([b - a for a, b in gaps])
    before = np.concatenate([[0.0], np.cumsum(lengths)])

    def f(x):
        x = np.asarray(x, dtype=float)
        k = np.searchsorted(starts, x, side="right")  # the gaps that start by x
        j = np.maximum(k - 1, 0)
        return np.where(k > 0, before[j] + np.clip(x - starts[j], 0.0, lengths[j]), 0.0)

    return f


def _nest(spans):
    """Each span's parent index (-1: none) among ``spans``, which lie on one
    thread, sorted by start and, at one start, the longest first."""
    parent, stack = [], []
    for i, (s, e, _) in enumerate(spans):
        while stack and s >= spans[stack[-1]][1]:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return parent


def summarize_spans(events: list) -> dict:
    """{name: {count, host_s, self_s, idle_s, device_s, h2d_bytes}} of the
    ``nmrgnn.*`` spans that start in the slice; {} where there are none."""
    slice_ = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE_SPAN]
    if not slice_:
        return {}
    t0 = float(slice_[0]["ts"])
    t1 = t0 + float(slice_[0]["dur"])
    threads = defaultdict(list)
    launches, work, busy = {}, [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d, cat = float(e["ts"]), float(e["dur"]), e.get("cat")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            if t0 <= s < t1:
                threads[(e.get("pid"), e.get("tid"))].append((s, s + d, e["name"]))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e.get("pid"), e.get("tid")), s)
        elif cat in DEVICE_CATS:
            if s + d > t0 and s < t1:
                busy.append((max(s, t0), min(s + d, t1)))
            if e.get("args", {}).get("correlation") is not None:
                work.append(e)
    if not threads:
        return {}
    idle_before = _idle_before(_union(busy), t0, t1)
    out = {}

    def entry(name):
        if name not in out:
            out[name] = {"count": 0, "host_s": 0.0, "self_s": 0.0, "idle_s": 0.0,
                         "device_s": 0.0, "h2d_bytes": None}
        return out[name]

    index = {}
    for key, spans in threads.items():
        spans.sort(key=lambda sp: (sp[0], -sp[1]))
        parent = _nest(spans)
        covered = [0.0] * len(spans)
        for i, p in enumerate(parent):
            if p >= 0:
                covered[p] += min(spans[i][1], spans[p][1]) - spans[i][0]
        starts = np.asarray([sp[0] for sp in spans])
        ends = np.asarray([sp[1] for sp in spans])
        idle = idle_before(ends) - idle_before(starts)
        for (s, e, name), cov, gap in zip(spans, covered, idle):
            row = entry(name)
            row["count"] += 1
            row["host_s"] += (e - s) * US
            row["self_s"] += (e - s - cov) * US
            row["idle_s"] += float(gap) * US
        index[key] = (starts, spans, parent)
    for ev in work:
        launch = launches.get(ev["args"]["correlation"])
        if launch is None or launch[0] not in index:
            continue
        starts, spans, parent = index[launch[0]]
        t = launch[1]
        i = int(np.searchsorted(starts, t, side="right")) - 1
        while i >= 0 and spans[i][1] < t:
            i = parent[i]
        if i < 0:
            continue
        row = out[spans[i][2]]
        if ev.get("cat") == "kernel":
            row["device_s"] += float(ev["dur"]) * US
        elif ev.get("cat") == "gpu_memcpy" and "HtoD" in ev.get("name", ""):
            nbytes = ev["args"].get("bytes")
            if nbytes is not None:
                row["h2d_bytes"] = (row["h2d_bytes"] or 0) + int(nbytes)
    return out


# -- the readings -------------------------------------------------------------------


def _slice_spans(rec: dict):
    """(the slice's summary, its spans) of a traced run whose slice completed
    requests, else (None, {})."""
    s = rec.get("slice")
    if not s or s.get("units", 0) <= 0:
        return None, {}
    return s, s.get("spans") or {}


def per_request(rec: dict, name: str, field: str, scale: float):
    """``field`` of span ``name`` over the requests of the slice, times
    ``scale``; None where the slice holds no such span or reading."""
    s, spans = _slice_spans(rec)
    value = spans.get(name, {}).get(field)
    return None if s is None or value is None else value * scale / s["units"]


def share_pct(rec: dict, part: str, whole: str):
    """Spans ``part`` as a share of spans ``whole`` by count, %."""
    _, spans = _slice_spans(rec)
    if whole not in spans:
        return None
    return 100.0 * spans.get(part, {}).get("count", 0) / spans[whole]["count"]


def idle_pct(rec: dict, names):
    """The device's idle time within spans ``names`` as a share of the
    slice, %."""
    s, spans = _slice_spans(rec)
    found = [spans[n]["idle_s"] for n in names if n in spans]
    if s is None or not found or s["slice_s"] <= 0:
        return None
    return 100.0 * sum(found) / s["slice_s"]


def roofline(rec: dict, part: str, name: str):
    """The least time of ``part``'s work (``flops/``) over the device time
    of the kernels launched under spans ``name``, %: as
    ``readers.roofline``, with the kernels picked by span, not by name."""
    s, spans = _slice_spans(rec)
    peaks = rec.get("peaks")
    busy = spans.get(name, {}).get("device_s", 0.0)
    if s is None or not peaks or busy <= 0:
        return None
    flops, nbytes = rec["work"][part]
    least = max(flops / peaks["flops"][rec["dtype"]], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least * s["units"] / busy


PREP = ("nmrgnn.permute", "nmrgnn.plan", "nmrgnn.h2d")
READ = {
    # host ms a request in the RCM permutation
    "permute_ms.predict": lambda rec: per_request(rec, "nmrgnn.permute", "host_s", 1e3),
    # host ms a request in the plan's check and, on a miss, its build
    "plan_ms.predict": lambda rec: per_request(rec, "nmrgnn.plan", "host_s", 1e3),
    # plan checks that missed and built a new plan, %
    "plan_miss_pct.predict": lambda rec: share_pct(rec, "nmrgnn.plan.build", "nmrgnn.plan"),
    # MB (1e6 bytes) a request copies host to device
    "h2d_mb.predict": lambda rec: per_request(rec, "nmrgnn.h2d", "h2d_bytes", 1e-6),
    # host ms a request enqueuing the forward's launches
    "dispatch_ms.predict": lambda rec: per_request(rec, "nmrgnn.forward", "host_s", 1e3),
    # the device idle under the host's preparation, % of the slice
    "prep_idle_pct.predict": lambda rec: idle_pct(rec, PREP),
    # the MP layers' least time over the kernels launched under nmrgnn.mp, %
    "attn_roofline_pct.predict": lambda rec: roofline(rec, "mp", "nmrgnn.mp"),
}


def readings(rec: dict) -> dict:
    """{name: value or None} of ``READ`` on a run's record."""
    return {name: read(rec) for name, read in READ.items()}
