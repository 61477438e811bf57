"""A small msgpack reader and writer for the subset flax's
``serialization.to_bytes`` writes: maps, arrays, str, bin, ext, nil, bools,
ints and floats.

flax stores each array as ext type 1 whose payload is itself msgpack:
``[shape, dtype name, raw little-endian bytes]``. ``unpackb`` returns the
ext payload as ``ExtType(code, data)``, like ``msgpack.unpackb``;
``restore_arrays`` turns flax's array ext values into numpy arrays and
maps keyed "0".."n-1" (flax's encoding of lists) into lists.
``state_dict`` is its inverse (lists as such maps, arrays as flax's ext
values) and ``packb`` writes the result, so flax's ``from_bytes`` reads
what the port writes.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

_FLAX_NDARRAY_EXT = 1


class ExtType(NamedTuple):
    code: int
    data: bytes


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",   # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",   # str
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}   # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return self.take(n)
            if b >= 0xD9:
                return self.take(n).decode("utf-8")
            code = self.unpack(">b")
            return ExtType(code, self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return ExtType(code, self.take(fixext[b]))
        if b in (0xDC, 0xDD):
            return self._array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes):
    """Decode one msgpack object; trailing bytes are an error."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after msgpack object")
    return out


def _ndarray(ext: ExtType) -> np.ndarray:
    shape, dtype, raw = unpackb(ext.data)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def restore_arrays(tree):
    """flax's state dict -> nested dicts and lists of numpy arrays."""
    if isinstance(tree, ExtType):
        if tree.code != _FLAX_NDARRAY_EXT:
            raise ValueError(f"unsupported msgpack ext type {tree.code}")
        return _ndarray(tree)
    if isinstance(tree, dict):
        keys = list(tree)
        if keys and all(isinstance(k, str) and k.isdigit() for k in keys) and \
                sorted(int(k) for k in keys) == list(range(len(keys))):
            return [restore_arrays(tree[str(i)]) for i in range(len(keys))]
        return {k: restore_arrays(v) for k, v in tree.items()}
    return tree


def _pack_len(out: bytearray, n: int, fix_base, fix_max: int, codes) -> None:
    """A length header: the fix form up to ``fix_max`` (when ``fix_base`` is
    given), else the 8/16/32-bit ``codes`` (None where the type has no
    such form)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if 0 <= v <= 0x7F:
            out.append(v)
        elif -32 <= v < 0:
            out.append(v & 0xFF)
        elif v >= 0:
            out.append(0xCF)
            out += struct.pack(">Q", v)
        else:
            out.append(0xD3)
            out += struct.pack(">q", v)
    elif isinstance(obj, (float, np.floating)):
        out.append(0xCB)
        out += struct.pack(">d", float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, ExtType):
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(obj.data) in fixext:
            out.append(fixext[len(obj.data)])
        else:
            _pack_len(out, len(obj.data), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", obj.code)
        out += obj.data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode one object (None, bool, int, float, str, bytes, ExtType,
    list/tuple, dict)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _ndarray_ext(a: np.ndarray) -> ExtType:
    a = np.ascontiguousarray(a)
    return ExtType(_FLAX_NDARRAY_EXT, packb([list(a.shape), a.dtype.name, a.tobytes()]))


def state_dict(tree):
    """Nested dicts and lists of numpy arrays as flax's state dict: lists
    as maps keyed "0".."n-1", arrays as flax's ndarray ext values."""
    if isinstance(tree, dict):
        return {str(k): state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    return _ndarray_ext(np.asarray(tree))
