"""TensorBoard event files without TensorFlow (``nmrgnn_tpu/utils/
tb_events.py``): ``events.out.tfevents.*`` files of TFRecord-framed Event
protos with scalar summaries, written with the port's protobuf encoder and
TFRecord writer (``data/tfrecord.py``). ``train --tensorboard`` logs its
epochs through it.

Wire format (tensorflow/core/util/event.proto):
  Event:   wall_time=1 (double), step=2 (int64), file_version=3 (string),
           summary=5 (Summary)
  Summary: value=1 (repeated Summary.Value)
  Value:   tag=1 (string), simple_value=2 (float)
"""
from __future__ import annotations

import os
import socket
import struct
import time

from ..data.tfrecord import TFRecordWriter, _len_delim, _tag, _varint


def _event(wall_time: float, step: int = 0, file_version: bytes = None,
           summary: bytes = None) -> bytes:
    out = _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _tag(2, 0) + _varint(step)
    if file_version is not None:
        out += _len_delim(3, file_version)
    if summary is not None:
        out += _len_delim(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _len_delim(1, tag.encode()) + _tag(2, 5) + struct.pack("<f", value)
    return _len_delim(1, val)


class EventWriter:
    """Append scalar events to a new tfevents file in ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._w = TFRecordWriter(os.path.join(logdir, fname), flush_every=64)
        self._w.write(_event(time.time(), file_version=b"brain.Event:2"))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._w.write(_event(time.time(), step=int(step),
                             summary=_scalar_summary(tag, float(value))))

    def scalars(self, logs: dict, step: int) -> None:
        """Every value of ``logs`` that is a number, under its key."""
        for tag, value in logs.items():
            try:
                self.scalar(tag, float(value), step)
            except (TypeError, ValueError):
                continue

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()
