"""LayerNorm over each row's features, optionally after a residual add,
beside its plain version.

``layer_norm(x, w, b, eps, residual=r)`` computes h = x + r, rounded to
x's dtype and written into x (the residual stream, updated in place), and
y = (h - mean) / sqrt(var + eps) * w + b with the row's mean and biased
variance in float32; without ``residual``, h = x and x is left as it is.
It returns (h, y). On a CUDA tensor it launches the hand-written kernel
(satae_torch/csrc/layernorm.cu, bf16 rows of a multiple of 8 up to 1,024,
w and b float32), counted in ``layer_norm.launches`` and run inside the
span ``satae.ln`` (counter ``rows``); on a CPU tensor it computes
:func:`layer_norm_plain`, in float32 or bf16. There is no fallback from
one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from satae_torch.kernels import _build
from satae_torch.kernels.matmul import launch_span

MAX_FEATURES = 1024  # the kernel's widest row


def _check(x, w, b, residual) -> None:
    if x.dim() != 2 or w.shape != (x.shape[1],) or b.shape != w.shape:
        raise ValueError(f"layer_norm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"layer_norm: residual {tuple(residual.shape)} "
                         f"{residual.dtype} is not x's {tuple(x.shape)} "
                         f"{x.dtype}")


def layer_norm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float, residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, the same contract: the statistics, the
    normalisation and the affine map in float32, y rounded once."""
    _check(x, w, b, residual)
    if residual is not None:
        x.copy_((x.float() + residual.float()).to(x.dtype))
    h = x.float()
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    y = (h - mean) / torch.sqrt(var + eps) * w.float() + b.float()
    return x, y.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float, residual: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, y) as the module docstring says, x (M, N) and ``residual`` of
    one dtype, w and b (N,). A CUDA x launches the kernel once: bf16 x and
    residual, contiguous and 16-byte aligned, N a multiple of 8 up to
    MAX_FEATURES, w and b float32 and contiguous; a CPU x takes
    :func:`layer_norm_plain`. Raises on a refused launch."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, w, b, eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    _check(x, w, b, residual)
    m, n = x.shape
    bufs = (x, residual, w, b)
    if x.dtype != torch.bfloat16 or n % 8 or n > MAX_FEATURES \
            or w.dtype != torch.float32 or b.dtype != torch.float32 \
            or any(t is not None and (not t.is_contiguous()
                                      or t.data_ptr() % 16) for t in bufs):
        raise ValueError(f"layer_norm: the kernel takes contiguous, "
                         f"16-byte-aligned bf16 rows of a multiple of 8 up "
                         f"to {MAX_FEATURES} and float32 w, b; got x "
                         f"{x.dtype} {tuple(x.shape)}, w {w.dtype}")
    y = torch.empty_like(x)
    if m == 0:
        return x, y
    with launch_span("satae.ln", layer_norm, x.dtype, rows=m):
        _build.launch(_build.load("layernorm"), "satae_layernorm_bf16",
                      x.device, x.data_ptr(),
                      0 if residual is None else residual.data_ptr(),
                      w.data_ptr(), b.data_ptr(),
                      0 if residual is None else x.data_ptr(), y.data_ptr(),
                      m, n, float(eps))
    return x, y


layer_norm.launches = _build.launch_counter()
