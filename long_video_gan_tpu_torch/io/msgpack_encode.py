"""A small pure-Python msgpack encoder for the subset flax writes.

The counterpart of `msgpack_decode.py`: encodes what
`flax.serialization.msgpack_serialize` writes for a tree of numpy arrays
(maps with string keys, strings, ints, floats, nil, bools, bytes, lists,
numpy arrays as ext type 1 and numpy scalars as ext type 3, each holding the
msgpack triple (shape, dtype name, raw C-order bytes)), with msgpack-python's
choice of the smallest format for each value, so a tree encodes to the bytes
flax would write. Needs neither the
`msgpack` nor the `flax` package.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class MsgpackEncodeError(TypeError):
    """A value outside the supported subset."""


def packb(value: Any) -> bytes:
    """Encode one object."""
    out = bytearray()
    _pack(value, out)
    return bytes(out)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise MsgpackEncodeError(f"int too large for msgpack: {v}")
    else:
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise MsgpackEncodeError(f"int too small for msgpack: {v}")


def _pack_len(n: int, out: bytearray, fix: tuple, tags: tuple) -> None:
    """A length header: fix = (first byte, limit) or None, then the 8/16/32
    bit tags (None where the format has no 8-bit form)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise MsgpackEncodeError(f"object too long for msgpack: {n}")


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(payload))
    if fixext is not None:
        out.append(fixext)
    else:
        _pack_len(len(payload), out, None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _pack(v: Any, out: bytearray) -> None:
    if isinstance(v, (np.ndarray, np.generic)):
        _pack_ext(_EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR,
                  _ndarray_payload(np.asarray(v)), out)
    elif v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(v, out)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _pack_len(len(raw), out, (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        _pack_len(len(raw), out, None, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(v, (list, tuple)):
        _pack_len(len(v), out, (0x90, 16), (None, 0xDC, 0xDD))
        for item in v:
            _pack(item, out)
    elif isinstance(v, dict):
        _pack_len(len(v), out, (0x80, 16), (None, 0xDE, 0xDF))
        for key in sorted(v):         # flax's tree copy sorts map keys
            _pack(key, out)
            _pack(v[key], out)
    else:
        raise MsgpackEncodeError(f"unsupported type for msgpack: {type(v).__name__}")
