"""Read-only loader for satae's ``.msgpack`` checkpoints, without flax.

satae saves ``{"params": ..., "bn_state": ...}`` with
``flax.serialization.to_bytes`` (satae/io/checkpoint.py): a msgpack map of
maps whose array leaves are msgpack ext type 1, each payload itself a msgpack
array ``(shape, dtype_name, raw_bytes)``; numpy scalars are ext type 3 with
the same payload. The machine that serves the port need not have flax or the
msgpack package, so this module decodes that subset of msgpack in Python
(nil, bool, ints, floats, str, bin, arrays, maps, ext) and returns nested
dicts of numpy arrays, equal to ``flax.serialization.msgpack_restore``.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

# first byte -> (struct format of the fixed-width value)
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# first byte -> struct format of the length prefix, for str / bin / ext
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_BIN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode()
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _STR:
            return bytes(self.take(self.unpack(_STR[b]))).decode()
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _ARRAY:
            return self.array(self.unpack(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            n = _FIXEXT[b]
        elif b in _EXT:
            n = self.unpack(_EXT[b])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ext(code: int, payload: bytes) -> Any:
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype, raw = unpackb(payload)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the subset flax writes)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return out


def load_model(path: str | Path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A satae ``save_model`` file -> (params, bn_state) numpy trees."""
    blob = unpackb(Path(path).read_bytes())
    if not isinstance(blob, dict) or not {"params", "bn_state"} <= set(blob):
        raise ValueError(f"{path}: not a satae model checkpoint (expected "
                         "'params' and 'bn_state')")
    return blob["params"], blob["bn_state"]
