"""ctypes binding of the repository's native JPEG loader (csrc/loader.cc):
the counterpart of satae/io/native_loader.py.

The library is built from that source with ``g++`` and libjpeg at first use,
into ``satae_torch/_build/loader_<digest>/`` (the digest hashes the source
and the flags, so an edited source builds anew), never into ``csrc/``. Where
it cannot be built (no compiler, no libjpeg headers), :func:`native_available`
is false and satae_torch.data.ingest decodes with PIL, as satae does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "csrc" / "loader.cc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return BUILD_ROOT / f"loader_{h.hexdigest()[:16]}" / "libsatae_loader.so"


def _build(so: Path) -> bool:
    """Compile into a file of this process and rename it into place, so
    processes building at once never load a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", tmp, *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError):
        return False
    finally:
        Path(tmp).unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path() if SOURCE.exists() else None
        if so is None or (not so.exists() and not _build(so)):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        lib.satae_decode_jpeg_batch.restype = ctypes.c_int
        lib.satae_decode_jpeg_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def decode_batch(paths: Sequence[str], image_size: int = 64,
                 n_threads: int = 0) -> np.ndarray:
    """Decode JPEGs to (N, image_size, image_size, 3) uint8 on all cores.
    Raises RuntimeError if any file fails to decode (a zero-filled slot
    would poison the data silently)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.empty((len(paths), image_size, image_size, 3), np.uint8)
    failed = lib.satae_decode_jpeg_batch(
        blob, len(paths), image_size, image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    if failed:
        raise RuntimeError(f"native decode failed for {failed} file(s)")
    return out
