"""TFRecord files of ``tf.train.Example`` records, without TensorFlow
(``nmrgnn_tpu/data/tfrecord.py``).

  * framing: [length u64le][masked crc32c(length) u32le][payload]
    [masked crc32c(payload) u32le];
  * payload: a ``tf.train.Example`` in protobuf's wire format (Example.
    features = 1, Features.feature = 1 (a map), Feature.{bytes_list = 1,
    float_list = 2, int64_list = 3}, *List.value = 1), coded by hand.

The framing and the CRCs go through the native runtime (``native.py``,
``native/src/tfrecord.cc``) when it builds and loads, and through the pure
Python below otherwise; both write and read the same bytes, and the JAX
package reads them.

Fragment record schema (``data/dataset.py``):
  atoms        int64[N]    element vocabulary indices
  nlist        int64[N*K]  neighbor indices
  edges        float[N*K]  neighbor distances (nm)
  shift        float[N]    label ppm (y[:, 0])
  name_idx     int64[N]    atom-name vocabulary index (y[:, 1])
  label_weight float[N]    label mask flag (y[:, 2])
  weight       float[N]    per-atom sample weight (w)
  k            int64[1]    neighbors per atom
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

import numpy as np

from .. import native

_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ _POLY, t >> 1).astype(np.uint32)
    return t


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli), byte by byte from a table: the pure-Python
    path."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ int(_TABLE[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC32C: native when available."""
    got = native.masked_crc(data)
    if got is not None:
        return got
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# protobuf wire format

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: memoryview, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


FeatureValue = Union[np.ndarray, List[bytes]]


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """{name: int or float array, or a list of bytes} as a
    ``tf.train.Example``; ints packed as varints, floats packed as
    little-endian float32, the features in sorted name order."""
    entries = []
    for key, val in sorted(features.items()):
        if isinstance(val, (list, tuple)) and (not val or isinstance(val[0], bytes)):
            feat = _len_delim(1, b"".join(_len_delim(1, v) for v in val))
        else:
            arr = np.asarray(val)
            if arr.dtype.kind in "iu":
                packed = b"".join(_varint(int(x) & 0xFFFFFFFFFFFFFFFF) for x in arr.ravel())
                feat = _len_delim(3, _len_delim(1, packed))
            elif arr.dtype.kind == "f":
                feat = _len_delim(2, _len_delim(1, arr.astype("<f4").tobytes()))
            else:
                raise TypeError(f"unsupported feature dtype {arr.dtype} for {key!r}")
        entries.append(_len_delim(1, _len_delim(1, key.encode()) + _len_delim(2, feat)))
    return _len_delim(1, b"".join(entries))


def _fields(buf: memoryview):
    """(field, value) of each field of a message: bytes for wire type 2,
    int for 0, float for 5."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, bytes(buf[pos:pos + ln])
            pos += ln
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, v
        elif wire == 5:
            yield field, struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unexpected wire type {wire}")


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def _int64_list(lst: bytes) -> np.ndarray:
    ints: List[int] = []
    for field, v in _fields(memoryview(lst)):
        if field != 1:
            continue
        if isinstance(v, bytes):  # packed
            mv, p = memoryview(v), 0
            while p < len(mv):
                x, p = _read_varint(mv, p)
                ints.append(_signed(x))
        else:
            ints.append(_signed(v))
    return np.asarray(ints, np.int64)


def _float_list(lst: bytes) -> np.ndarray:
    vals: List[float] = []
    for field, v in _fields(memoryview(lst)):
        if field != 1:
            continue
        if isinstance(v, bytes):  # packed
            vals.extend(np.frombuffer(v, "<f4").tolist())
        else:
            vals.append(v)
    return np.asarray(vals, np.float32)


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    """A ``tf.train.Example`` as {name: np.ndarray, or a list of bytes}."""
    out: Dict[str, FeatureValue] = {}
    for f_field, features_msg in _fields(memoryview(data)):
        if f_field != 1:
            continue
        for e_field, entry in _fields(memoryview(features_msg)):
            if e_field != 1:
                continue
            key = feat = None
            for k_field, v in _fields(memoryview(entry)):
                if k_field == 1:
                    key = v.decode()
                elif k_field == 2:
                    feat = v
            if key is None or feat is None:
                continue
            for t_field, lst in _fields(memoryview(feat)):
                if t_field == 1:
                    out[key] = [v for _, v in _fields(memoryview(lst))]
                elif t_field == 2:
                    out[key] = _float_list(lst)
                elif t_field == 3:
                    out[key] = _int64_list(lst)
    return out


class TFRecordWriter:
    """Buffered TFRecord writer: records are framed and written in bulk at
    ``flush()`` (every ``flush_every`` records and at ``close()``), by the
    native runtime when available. A record is in the file only after a
    flush; use the writer as a context manager. Writing after ``close()``
    raises."""

    def __init__(self, path: str, append: bool = False, flush_every: int = 512):
        self._path = path
        self._flush_every = flush_every
        self._buf: list = []
        self._closed = False
        if not append:
            open(path, "wb").close()

    def write(self, payload: bytes) -> None:
        if self._closed:
            raise ValueError(f"write to closed TFRecordWriter({self._path!r})")
        self._buf.append(bytes(payload))
        if len(self._buf) >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        if not native.tfrecord_write(self._path, self._buf, append=True):
            with open(self._path, "ab") as f:
                for payload in self._buf:
                    header = struct.pack("<Q", len(payload))
                    f.write(header + struct.pack("<I", masked_crc(header)) + payload
                            + struct.pack("<I", masked_crc(payload)))
        self._buf.clear()

    def write_example(self, features: Dict[str, FeatureValue]) -> None:
        self.write(encode_example(features))

    def close(self) -> None:
        self.flush()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecord(path: str, check_crc: bool = False) -> Iterator[bytes]:
    """The record payloads of a TFRecord file, in order (the native scan
    when available). ``check_crc`` raises IOError on a CRC mismatch."""
    scanned = native.tfrecord_scan(path, check_crc=check_crc)
    if scanned is not None:
        with open(path, "rb") as f:
            data = f.read()
        for off, ln in zip(*scanned):
            yield data[off:off + ln]
        return
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if check_crc and (masked_crc(header) != hcrc or masked_crc(payload) != pcrc):
                raise IOError(f"CRC mismatch in {path}")
            yield payload


def read_examples(path: str, check_crc: bool = False) -> Iterator[Dict[str, FeatureValue]]:
    for payload in read_tfrecord(path, check_crc):
        yield decode_example(payload)
