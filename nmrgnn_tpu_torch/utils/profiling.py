"""Profiling and timing (``nmrgnn_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (host operators of every
thread, and the card's kernels when one is present) and writes it as a
Chrome trace into its directory; ``TimingBuckets`` are named wall-clock
accumulators (the eval-struct buckets); ``device_time`` times a step on
its device: CUDA events on the card, ``time.perf_counter`` on the CPU.

``span`` marks a stretch of the program's own work (``nmrgnn.*``) in the
trace of whatever ``torch.profiler`` session is recording, on the same
clock as its kernels and copies; with no session it costs a flag test.
It is not in ``utils.__all__``, which stays the JAX package's list.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler session
    records, else one shared null context. The test is torch's
    process-wide flag, so ``predict_trajectory``'s build threads see a
    session that the consumer started (torch's thread-local test does not)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block, the host operators
    and ``span``s of every thread; on exit write it to
    ``log_dir/trace-<pid>-<ns>.json`` (Chrome trace format, for
    chrome://tracing or Perfetto; default directory ``nmrgnn_trace`` in
    the temporary directory). Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "nmrgnn_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class TimingBuckets:
    """Named wall-clock accumulators (eval-struct style)."""

    def __init__(self, *names: str):
        self.ns: Dict[str, int] = {n: 0 for n in names}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.ns[name] = self.ns.get(name, 0) + time.time_ns() - t0

    def summary(self) -> str:
        return "|".join(f"{k}:{v/1e9:5.2f}s" for k, v in self.ns.items())


def device_time(
    step: Callable[[torch.Tensor], torch.Tensor],
    carry0: torch.Tensor,
    iters: int = 48,
    repeats: int = 5,
) -> float:
    """Seconds per invocation of ``step`` (carry -> carry) on ``carry0``'s
    device: the slope between chains of ``iters // 3`` and ``iters`` calls,
    the best of ``repeats`` each, so that a chain's fixed cost cancels.
    Timed with CUDA events on the card (no host clock in the chain) and
    with ``time.perf_counter`` on the CPU."""
    cuda = carry0.device.type == "cuda"

    def chain(k: int) -> float:
        c = carry0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                c = step(c)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            c = step(c)
        float(c.sum())
        return time.perf_counter() - t0

    chain(1)  # warm up: builds, caches
    k_lo = max(iters // 3, 1)
    t_lo = min(chain(k_lo) for _ in range(repeats))
    t_hi = min(chain(iters) for _ in range(repeats))
    return max((t_hi - t_lo) / max(iters - k_lo, 1), 1e-9)
