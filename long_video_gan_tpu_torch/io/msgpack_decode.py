"""A small pure-Python msgpack decoder for the subset flax writes.

`.lvg` checkpoint bodies are `flax.serialization.msgpack_serialize` output:
maps, strings, ints, floats, nil and bools, with numpy arrays as ext type 1
and numpy scalars as ext type 3, each holding the msgpack triple
(shape, dtype name, raw C-order bytes). This decodes that subset without the
`msgpack` or `flax` packages. Arrays come back as read-only numpy arrays over
the input buffer; bfloat16 ones are widened to float32 (exact), since numpy
has no bfloat16 of its own.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class MsgpackError(ValueError):
    """Malformed input, or a msgpack type outside the supported subset."""


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of `data`."""
    value, pos = _Decoder(data).decode(0)
    if pos != len(data):
        raise MsgpackError(f"{len(data) - pos} trailing bytes after the msgpack object")
    return value


def _decode_ndarray(payload: memoryview) -> np.ndarray:
    shape, dtype_name, raw = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


class _Decoder:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)

    def _take(self, pos: int, n: int) -> tuple[memoryview, int]:
        end = pos + n
        if end > len(self.buf):
            raise MsgpackError("truncated msgpack input")
        return self.buf[pos:end], end

    def _unpack(self, fmt: str, pos: int) -> tuple[Any, int]:
        raw, pos = self._take(pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos

    def _str(self, pos: int, n: int) -> tuple[str, int]:
        raw, pos = self._take(pos, n)
        return bytes(raw).decode("utf-8"), pos

    def _array(self, pos: int, n: int) -> tuple[list, int]:
        out = []
        for _ in range(n):
            item, pos = self.decode(pos)
            out.append(item)
        return out, pos

    def _map(self, pos: int, n: int) -> tuple[dict, int]:
        out = {}
        for _ in range(n):
            key, pos = self.decode(pos)
            out[key], pos = self.decode(pos)
        return out, pos

    def _ext(self, pos: int, code: int, n: int) -> tuple[Any, int]:
        payload, pos = self._take(pos, n)
        if code == _EXT_NDARRAY:
            return _decode_ndarray(payload), pos
        if code == _EXT_NPSCALAR:
            return _decode_ndarray(payload)[()], pos
        raise MsgpackError(f"unsupported msgpack ext type {code}")

    def decode(self, pos: int) -> tuple[Any, int]:
        tag, pos = self._take(pos, 1)
        b = tag[0]
        if b <= 0x7F:
            return b, pos
        if b >= 0xE0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8F:
            return self._map(pos, b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(pos, b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(pos, b & 0x1F)
        if b == 0xC0:
            return None, pos
        if b == 0xC2:
            return False, pos
        if b == 0xC3:
            return True, pos
        if b in (0xC4, 0xC5, 0xC6):                       # bin 8/16/32
            n, pos = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b], pos)
            raw, pos = self._take(pos, n)
            return bytes(raw), pos
        if b in (0xC7, 0xC8, 0xC9):                       # ext 8/16/32
            n, pos = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b], pos)
            code, pos = self._unpack(">b", pos)
            return self._ext(pos, code, n)
        if b == 0xCA:
            return self._unpack(">f", pos)
        if b == 0xCB:
            return self._unpack(">d", pos)
        if 0xCC <= b <= 0xD3:                             # uint/int 8..64
            return self._unpack(">" + "BHIQbhiq"[b - 0xCC], pos)
        if 0xD4 <= b <= 0xD8:                             # fixext 1..16
            code, pos = self._unpack(">b", pos)
            return self._ext(pos, code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                       # str 8/16/32
            n, pos = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b], pos)
            return self._str(pos, n)
        if b in (0xDC, 0xDD):                             # array 16/32
            n, pos = self._unpack(">H" if b == 0xDC else ">I", pos)
            return self._array(pos, n)
        if b in (0xDE, 0xDF):                             # map 16/32
            n, pos = self._unpack(">H" if b == 0xDE else ">I", pos)
            return self._map(pos, n)
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")
