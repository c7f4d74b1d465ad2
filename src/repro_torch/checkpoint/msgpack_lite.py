"""A small MessagePack encoder and decoder for the checkpoint manifest.

The reference writes its manifest with the ``msgpack`` package, which the
card's machine does not have.  This module covers the subset a manifest
uses -- map, str, int, float, bool, nil and array -- in the MessagePack
specification's encoding, choosing the smallest form for each value as
``msgpack.packb`` does (floats as float64), so that either package reads
the other's manifests.  ``unpackb`` returns maps as dicts and arrays as
lists (``msgpack.unpackb``'s defaults).
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


class MsgpackError(ValueError):
    """Bytes that are not a MessagePack value of the supported subset, or
    a value that the subset cannot encode."""


def _sized(n: int, small: Tuple[int, int], codes: Tuple[int, int, int]
           ) -> bytes:
    """The header of a str/array/map of length ``n``: the fix form
    ``small = (prefix, limit)`` when ``n < limit``, else the 8-, 16- or
    32-bit length form ``codes`` (0: none)."""
    prefix, limit = small
    if n < limit:
        return bytes([prefix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise MsgpackError(f"length {n} is too long for MessagePack")


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if x >= low:
                return bytes([code]) + struct.pack(fmt, x)
    raise MsgpackError(f"integer {x} does not fit 64 bits")


def _pack(x: Any, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(int(x)))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_sized(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), (0x90, 16), (0, 0xDC, 0xDD)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_sized(len(x), (0x80, 16), (0, 0xDE, 0xDF)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise MsgpackError(f"cannot encode {type(x).__name__} {x!r}")


def packb(x: Any) -> bytes:
    """``x`` (dicts, lists, tuples, str, int, float, bool, None) as
    MessagePack bytes."""
    out: list = []
    _pack(x, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
        0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated MessagePack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if c in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[c]
        if c in _FIXED:
            return self.unpack(_FIXED[c])
        if c in _LEN:
            n = self.unpack(_LEN[c])
            if c in (0xD9, 0xDA, 0xDB):
                return self.str(n)
            return self.array(n) if c in (0xDC, 0xDD) else self.map(n)
        raise MsgpackError(f"unsupported MessagePack type byte 0x{c:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """The value MessagePack ``data`` holds; trailing bytes raise."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes after the value")
    return out
