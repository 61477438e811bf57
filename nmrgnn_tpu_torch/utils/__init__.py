"""Profiling and timing helpers, and the TensorBoard event writer."""
from .profiling import TimingBuckets, device_time, trace

__all__ = ["TimingBuckets", "device_time", "trace"]
