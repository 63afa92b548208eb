"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each ``satae_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, under
``satae_torch/_build/<digest>/``, where the digest hashes every source and
header in ``csrc/`` and the compiler flags: an edited source builds anew, an
unchanged one loads the library already there. All libraries are compiled
together, one ``nvcc`` process per source.

No PyTorch headers are compiled (a source that includes them takes minutes to
build), so nothing here needs ``ninja``: pointers and the stream cross the C
interface as ``void*``, and each wrapper checks shapes, dtypes and contiguity
in Python before the call. The pattern follows the repository's other
build-at-first-use binding, satae/io/native_loader.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# source -> {launcher: number of int arguments}. Every launcher takes five
# device pointers (x, w, scale, shift, out), its int arguments, then the
# stream, and returns cudaGetLastError().
LAUNCHERS = {"fused_gemm": {"satae_fused_gemm": 4, "satae_fused_gemm_t": 6},
             "conv_bn_act": {"satae_conv2d_bn_act": 12}}
SOURCES = tuple(LAUNCHERS)
# No --use_fast_math: expf in the sigmoid epilogue stays accurate.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the first ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of satae_torch are built at first "
            "use on a machine with the CUDA toolkit")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    the library paths. Raises RuntimeError with the compiler's output on a
    failed build. The ptxas report (registers, spills, shared memory) of each
    build is kept beside its library as ``<name>.log``."""
    out = build_dir()
    libs = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [name for name, so in libs.items() if not so.is_file()]
    if not todo:
        return libs
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def ptxas_report() -> str:
    """The ptxas report (registers, spills, shared memory) of the build."""
    out = build_dir()
    lines = []
    for name in SOURCES:
        log = out / f"{name}.log"
        if log.is_file():
            lines += [ln for ln in log.read_text().splitlines()
                      if "ptxas" in ln or "spill" in ln]
    return "\n".join(lines)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            for fn_name, n_ints in LAUNCHERS[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * 5
                               + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
            lib.satae_error_string.restype = ctypes.c_char_p
            lib.satae_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check_operands(what: str, device, **tensors) -> None:
    """The kernels take contiguous float32 tensors on one CUDA device."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{what}: {name} is {t.dtype}; the CUDA kernels take float32 "
                "only (bf16 inputs are a later slice, ROADMAP.md §2)")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.satae_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
