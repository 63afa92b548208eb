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
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# source -> {launcher: (device pointers, int arguments)}. A launcher takes
# its pointers (x, w, scale, shift, out, then K1's split-K workspace and
# counters), its int arguments, then the stream, and returns
# cudaGetLastError() (``satae_conv2d_bn_act_tma`` takes a third pointer
# after x and w, the weight's TF32 halves). K2 has a float32 and a bf16
# launcher on gemm_tile.cuh's mma.sync loop (bf16: x, w and out bf16;
# scale, shift and the workspace float32), and one of each on wgmma with
# TMA loads (``_tma``, ``_bf16_tma``) for buffers TMA can read. K1 has the
# same four, each over a leading config axis (``_batched``,
# ``_batched_bf16``, ``_batched_tma``, ``_batched_bf16_tma``: C products in
# one launch, the config count C first among the ints; a 2-D product is C
# = 1), and a wide bf16 one in a library of its own (``gemm_wide``: x, w,
# scale, shift, out; M, N, K, act), for the ViT encoder's large products.
# The ViT encoder's kernels are bf16 only: attention (qkv, out; B, L, H)
# and LayerNorm (x, r, w, b, sum, out; M, N; then one float, eps): a third
# count, where there is one, is the launcher's float arguments, after its
# ints.
LAUNCHERS = {"fused_gemm": {"satae_fused_gemm_batched": (7, 10),
                            "satae_fused_gemm_batched_bf16": (7, 10),
                            "satae_fused_gemm_batched_tma": (5, 9),
                            "satae_fused_gemm_batched_bf16_tma": (5, 9)},
             "conv_bn_act": {"satae_conv2d_bn_act": (5, 13),
                             "satae_conv2d_bn_act_bf16": (5, 13),
                             "satae_conv2d_bn_act_tma": (6, 13),
                             "satae_conv2d_bn_act_bf16_tma": (5, 13)},
             "gemm_wide": {"satae_fused_gemm_bf16_wide": (5, 4)},
             "attention": {"satae_attention_bf16": (2, 3)},
             "layernorm": {"satae_layernorm_bf16": (6, 2, 1)}}
# the operand dtypes the kernels take, and each one's launcher suffix
OPERAND_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}
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


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names):
    """C++ names of mangled symbols (c++filt where it is installed)."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return list(names)
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def ptxas_report() -> list:
    """One dict per kernel instantiation of the build, from ptxas -v:
    kernel (demangled), registers, static shared memory bytes, spill store
    and load bytes. Dynamic shared memory (the stage ring) is not in
    ptxas's count."""
    rows = []
    for name in SOURCES:
        log = build_dir() / f"{name}.log"
        if not log.is_file():
            continue
        cur = None
        for ln in log.read_text().splitlines():
            m = _ENTRY.search(ln)
            if m:
                cur = dict(source=name, kernel=m.group(1), registers=None,
                           smem=0, spill_stores=0, spill_loads=0)
                rows.append(cur)
            elif cur is not None:
                if (m := _SPILLS.search(ln)):
                    cur["spill_stores"] = int(m.group(1))
                    cur["spill_loads"] = int(m.group(2))
                if (m := _REGS.search(ln)):
                    cur["registers"] = int(m.group(1))
                if (m := _SMEM.search(ln)):
                    cur["smem"] = int(m.group(1))
    for row, pretty in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = pretty.split("(")[0]
    return rows


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            for fn_name, (n_ptrs, n_ints, *n_floats) in \
                    LAUNCHERS[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                               + [ctypes.c_int] * n_ints
                               + [ctypes.c_float] * sum(n_floats)
                               + [ctypes.c_void_p])
            lib.satae_error_string.restype = ctypes.c_char_p
            lib.satae_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check_dtypes(what: str, x: torch.Tensor, w: torch.Tensor,
                 scale=None, shift=None) -> str:
    """Refuse what no instantiation takes, on every device: x and w must be
    a float32 or a bf16 pair (a bf16 x with a float32 w would silently
    promote in the plain versions; the callers cast, as satae's do), scale
    and shift float32 (None is not checked). Returns the launcher suffix of
    the operands' dtype."""
    if x.dtype not in OPERAND_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what}: operands x {x.dtype} and w {w.dtype}; "
                        "expected a float32 or a bf16 pair")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected "
                            "torch.float32")
    return OPERAND_DTYPES[x.dtype]


def check_operands(what: str, device, x: torch.Tensor, w: torch.Tensor,
                   scale=None, shift=None) -> str:
    """:func:`check_dtypes`, and the kernels take contiguous tensors on one
    CUDA device (a scale or shift given as None is not checked). Returns the
    launcher suffix of the operands' dtype."""
    suffix = check_dtypes(what, x, w, scale, shift)
    for name, t in (("x", x), ("w", w), ("scale", scale), ("shift", shift)):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return suffix


def launch_counter() -> Dict[str, int]:
    """A wrapper's launch counts, one per instantiation, keyed by its
    launcher suffix."""
    return dict.fromkeys(OPERAND_DTYPES.values(), 0)


def launch(lib: ctypes.CDLL, fn_name: str, device: torch.device,
           *args) -> None:
    """Call launcher ``fn_name`` with ``args`` and the current stream of
    ``device``, made the current device only when it is not already, and
    raise on a refused launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = getattr(lib, fn_name)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    check(lib, rc, fn_name)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.satae_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
