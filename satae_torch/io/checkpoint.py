"""satae's run-directory artifacts without flax: the ``.msgpack``
checkpoints (read and written), their JSON sidecars and the grid-result
stores. The counterpart of satae/io/checkpoint.py.

satae saves ``{"params": ..., "bn_state": ...}`` with
``flax.serialization.to_bytes(jax.device_get(tree))``: a msgpack map of maps
(keys sorted, as jax's tree map leaves them) whose array leaves are msgpack
ext type 1, each payload itself a msgpack array ``(shape, dtype_name,
raw_bytes)``; flax reads numpy scalars as ext type 3 with the same payload
(``device_get`` has made them 0-d arrays before flax writes). The
machine that runs the port need not have flax or the msgpack package, so
this module reads and writes that subset of msgpack in Python (nil, bool,
ints, floats, str, bin, arrays, maps, ext). :func:`unpackb` returns nested
dicts of numpy arrays, equal to ``flax.serialization.msgpack_restore``;
:func:`packb` writes the bytes flax writes, so a checkpoint, and the sha1
fingerprint of an encoder that ``SatAEPipeline`` keeps beside the MLP store,
are the same in both packages. The trees are satae's layout
(satae_torch.io.convert carries them to and from the port's modules).

:class:`GridResultStore` and :func:`save_model`'s sidecar write the same
strict JSON as satae, with the same store keys, so a run directory written
by either package is resumed by the other.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from satae_torch.utils.strict_json import dump_strict_json, json_restore

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


def _header(out: List[bytes], n: int, fix: Optional[int], fix_max: int,
            wide: Tuple[Optional[int], int, int]) -> None:
    """A length header, the smallest msgpack-python writes: the fix form
    (``fix | n``) below ``fix_max``, else 8/16/32-bit (``wide``'s first
    bytes; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
    elif wide[0] is not None and n <= 0xff:
        out.append(struct.pack(">BB", wide[0], n))
    elif n <= 0xffff:
        out.append(struct.pack(">BH", wide[1], n))
    elif n <= 0xffffffff:
        out.append(struct.pack(">BI", wide[2], n))
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


_INT_FORMS = ((0, 0x7f, "B", None), (-0x20, -1, "b", None),
              (0x80, 0xff, ">BB", 0xcc), (-0x80, -1, ">Bb", 0xd0),
              (0x100, 0xffff, ">BH", 0xcd), (-0x8000, -1, ">Bh", 0xd1),
              (0x10000, 0xffffffff, ">BI", 0xce),
              (-0x80000000, -1, ">Bi", 0xd2),
              (0x100000000, 0xffffffffffffffff, ">BQ", 0xcf),
              (-0x8000000000000000, -1, ">Bq", 0xd3))


def _pack_int(out: List[bytes], v: int) -> None:
    # msgpack-python's order of forms, first match wins
    for lo, hi, fmt, byte in _INT_FORMS:
        if lo <= v <= hi:
            out.append(struct.pack(fmt, v) if byte is None
                       else struct.pack(fmt, byte, v))
            return
    raise OverflowError(f"integer {v} does not fit msgpack")


def _ext_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct \
            or arr.dtype.kind == "c":
        raise TypeError(f"cannot write an array of dtype {arr.dtype}")
    out: List[bytes] = []
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")],
          in_tree=False)
    return b"".join(out)


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(bytes((fixext[n],)))
    else:
        _header(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out.append(struct.pack("b", code))
    out.append(data)


def _pack(out: List[bytes], v: Any, in_tree: bool) -> None:
    # in a tree, dict keys are sorted and lists refused (flax would write
    # them as {"0": ...} maps); an ext payload is a plain list
    # numpy scalars first (np.float64 is a float, np.bool_ is not a bool):
    # jax.device_get turns them into 0-d arrays, so flax writes them as
    # ext type 1, never as its scalar type 3
    if isinstance(v, (np.ndarray, np.generic)):
        _pack_ext(out, _EXT_NDARRAY, _ext_payload(np.asarray(v)))
    elif v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(struct.pack(">Bd", 0xcb, v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _header(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(raw)
    elif isinstance(v, bytes):
        _header(out, len(v), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(v)
    elif isinstance(v, dict):
        _header(out, len(v), 0x80, 16, (None, 0xde, 0xdf))
        for k in (sorted(v) if in_tree else v):
            _pack(out, str(k), in_tree)
            _pack(out, v[k], in_tree)
    elif isinstance(v, list) and not in_tree:
        _header(out, len(v), 0x90, 16, (None, 0xdc, 0xdd))
        for x in v:
            _pack(out, x, in_tree)
    else:
        raise TypeError(f"cannot write {type(v).__name__} into a checkpoint "
                        "tree (dicts with array, scalar or string leaves)")


def packb(tree: Any) -> bytes:
    """Encode a tree of dicts with numpy-array (or scalar, string, None)
    leaves: the bytes of ``flax.serialization.to_bytes(jax.device_get(
    tree))``. Dict keys are written sorted, as jax's tree map leaves them;
    arrays, and numpy scalars as the 0-d arrays ``device_get`` makes of
    them, as ext type 1 over ``(shape, dtype name, C-order bytes)``; every
    header in the smallest form msgpack-python chooses. Arrays past flax's
    1 GiB chunk size are not supported."""
    out: List[bytes] = []
    _pack(out, tree, in_tree=True)
    return b"".join(out)


def _atomic_write(path: Path, data: bytes) -> None:
    """tmp + rename, so a kill mid-write never leaves a truncated file (the
    resume paths read these back). The tmp name carries the pid: processes
    that write the same artifact never rename each other's half-written
    file."""
    tmp = path.with_suffix(path.suffix + f".tmp.{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _atomic_write_text(path: Path, text: str) -> None:
    _atomic_write(path, text.encode())


def save_pytree(path: str | Path, tree: Any) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _atomic_write(path, packb(tree))


def save_model(path: str | Path, params: Any, bn_state: Any,
               meta: Optional[Dict[str, Any]] = None) -> None:
    """satae's ``save_model``: ``{"params", "bn_state"}`` as ``.msgpack``,
    and with ``meta`` a strict-JSON ``.json`` sidecar beside it."""
    save_pytree(path, {"params": params, "bn_state": bn_state})
    if meta is not None:
        _atomic_write_text(Path(path).with_suffix(".json"),
                           dump_strict_json(meta, indent=2))


def load_model(path: str | Path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A satae ``save_model`` file -> (params, bn_state) numpy trees."""
    blob = unpackb(Path(path).read_bytes())
    if not isinstance(blob, dict) or not {"params", "bn_state"} <= set(blob):
        raise ValueError(f"{path}: not a satae model checkpoint (expected "
                         "'params' and 'bn_state')")
    return blob["params"], blob["bn_state"]


def load_grid_results(path: str | Path) -> Dict[str, Dict[str, Any]]:
    """Read a ``validation_losses.json`` / ``mlp_results.json`` with the
    strict-JSON restore (diverged configs store "inf"/"nan" strings)."""
    return GridResultStore(path).results


class GridResultStore:
    """The per-config result store of a sweep, flushed after every config
    so a crash mid-sweep resumes (the reference's validation_losses.json)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.results: Dict[str, Dict[str, Any]] = {}
        if self.path.exists():
            self.results = json_restore(json.loads(self.path.read_text()))

    @staticmethod
    def key(**hparams) -> str:
        """satae's key: the hyperparameters as JSON, names sorted."""
        return json.dumps({k: hparams[k] for k in sorted(hparams)})

    def __contains__(self, key: str) -> bool:
        return key in self.results

    def record(self, key: str, value: Dict[str, Any]) -> None:
        self.results[key] = value
        self.path.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write_text(self.path,
                           dump_strict_json(self.results, indent=2))
