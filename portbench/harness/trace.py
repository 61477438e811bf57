"""The traced slice of a run: ``torch.profiler`` over a stretch of the
cell's traffic after the measured window, read back from its Chrome
trace.

What the slice gives the per-layer readers (``Slice.summary``):
  slice_s       the slice's length (the "portbench.slice" span)
  busy_s        the union of the device's activity (kernels, copies, fills) in it
  launches      kernel launches in it
  layer_s       device seconds of the kernels each ``kernels/*.json`` assigns to a layer
  device_ops    the kernels that took most device time, [name, seconds]
  idle_gaps     the longest idle gaps' time by the host operation under
                their middle (the innermost one), [name, seconds]
  spans         the program's ``nmrgnn.*`` spans in it (``harness/spans.py``)
"""
from __future__ import annotations

import glob
import json
import os
import re
import tempfile
from collections import defaultdict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE_SPAN = "portbench.slice"
TOP = 10
LONGEST_GAPS = 1000  # the idle gaps attributed to a host operation


def kernel_layers(root: str) -> list:
    """[(layer, [patterns])] of ``kernels/*.json``: a kernel belongs to the
    layer of the first file (in name order) with a pattern found in its
    name (a regular expression, searched)."""
    out = []
    for path in sorted(glob.glob(os.path.join(root, "kernels", "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        out.append((spec["layer"], [re.compile(p) for p in spec["patterns"]]))
    return out


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list, layers: list) -> dict:
    """The slice's numbers from Chrome trace events (``ts``/``dur`` in us)."""
    span = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE_SPAN]
    if not span:
        raise RuntimeError(f"the trace holds no {SLICE_SPAN} span")
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= t0 or s >= t1:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((max(s, t0), min(s + d, t1), e))
        elif e.get("cat") in HOST_CATS and e.get("name") != SLICE_SPAN:
            host.append((s, s + d, e.get("name", "?")))
    busy = _union([(s, e) for s, e, _ in dev])
    by_kernel = defaultdict(float)
    layer_s = defaultdict(float)
    launches = 0
    for s, e, ev in dev:
        if ev.get("cat") != "kernel":
            continue
        launches += 1
        name = ev.get("name", "?")
        by_kernel[name] += (e - s) * 1e-6
        for layer, patterns in layers:
            if any(p.search(name) for p in patterns):
                layer_s[layer] += (e - s) * 1e-6
                break
    gaps = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = sorted(((g1 - g0, g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0),
                  reverse=True)
    h0 = np.asarray([h[0] for h in host])
    h1 = np.asarray([h[1] for h in host])
    for length, g0, g1 in idle[:LONGEST_GAPS]:
        mid = 0.5 * (g0 + g1)
        cover = np.nonzero((h0 <= mid) & (h1 >= mid))[0]
        under = (host[cover[np.argmin(h1[cover] - h0[cover])]][2] if cover.size
                 else "(no host operation)")
        gaps[under] += length * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {
        "slice_s": (t1 - t0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "launches": launches,
        "layer_s": dict(layer_s),
        "device_ops": top(by_kernel),
        "idle_gaps": top(gaps),
    }


class Slice:
    """Profiles the work done between ``begin()`` and ``end()``; ``units``
    counts the requests the traffic completed in between."""

    def __init__(self, root: str):
        self.root = root
        self.units = 0
        self.summary = None
        self._prof = None
        self._span = None

    def begin(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._span = torch.profiler.record_function(SLICE_SPAN)
        self._span.__enter__()
        self.units = 0

    def end(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        from portbench.harness.spans import summarize_spans  # spans.py imports this module

        self.summary = summarize(events, kernel_layers(self.root))
        self.summary["spans"] = summarize_spans(events)
        self.summary["units"] = self.units

    @property
    def active(self) -> bool:
        return self._prof is not None
