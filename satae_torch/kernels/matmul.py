"""Fused matmul: out = act((x @ w) * scale + shift), kernel K1 and its plain
version.

Counterpart of satae/kernels/matmul.py: ``fused_matmul``'s forward, and
``linear_pallas``, which is the same kernel with scale 1 and shift = bias
(satae_torch.models.fast_infer folds those once per weight set). On a CUDA
tensor :func:`fused_matmul` launches the hand-written Hopper kernel
``fused_gemm`` (satae_torch/csrc/fused_gemm.cu); on a CPU tensor it computes
:func:`fused_matmul_plain`. There is no fallback from one to the other: a
kernel that fails to build or launch raises.

The TPU kernel's backward (``fused_matmul``'s custom VJP) is not ported yet:
no serving code differentiates through it (ROADMAP.md §2).
"""

from __future__ import annotations

import torch

from satae_torch.kernels import _build

ACTS = ("none", "relu", "sigmoid")


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    return y


def fused_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """The plain PyTorch version of K1: float32 product and epilogue, output
    in x's dtype."""
    y = (x.float() @ w.float()) * scale.float() + shift.float()
    return apply_act(y, act).to(x.dtype)


def _fused_gemm_cuda(x, w, scale, shift, act):
    m, k = x.shape
    n = w.shape[1]
    _build.check_operands("fused_gemm", x.device, x=x, w=w, scale=scale,
                          shift=shift)
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError(f"fused_gemm: shape {(m, k, n)} exceeds int32 "
                         "indexing")
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    lib = _build.load("fused_gemm")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.satae_fused_gemm(x.data_ptr(), w.data_ptr(),
                                  scale.data_ptr(), shift.data_ptr(),
                                  out.data_ptr(), m, n, k, ACTS.index(act),
                                  stream)
    _build.check(lib, rc, "fused_gemm")
    fused_matmul.launches += 1
    return out


def fused_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """act((x @ w) * scale + shift) for x (M, K), w (K, N) row-major and
    per-column scale/shift (N,).

    A CUDA x launches K1 (``fused_matmul.launches`` counts the launches); a
    CPU x takes :func:`fused_matmul_plain`."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_matmul: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    n = w.shape[1]
    if scale.shape != (n,) or shift.shape != (n,):
        raise ValueError(f"fused_matmul: scale/shift must be ({n},), got "
                         f"{tuple(scale.shape)}, {tuple(shift.shape)}")
    if x.device.type == "cuda":
        return _fused_gemm_cuda(x, w, scale, shift, act)
    if x.device.type == "cpu":
        return fused_matmul_plain(x, w, scale, shift, act)
    raise ValueError(f"fused_matmul: no kernel for device {x.device}")


fused_matmul.launches = 0

