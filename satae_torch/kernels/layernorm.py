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

``layer_norm_post(h, x, w, b, eps)`` is the post mode of a res-post-norm
block (the Swin encoder's): h = h + (LN(x) * w + b), the statistics, the
normalisation and the add in float32, rounded once to h's dtype and
written into h (the residual stream, updated in place); it returns h. On a
CUDA tensor it launches a kernel of its own (the pre-norm kernel's code
stays as it was), counted in ``layer_norm.launches`` too and run inside the
span ``satae.ln`` with the counters ``rows`` and ``post`` (1); on a CPU
tensor it computes :func:`layer_norm_post_plain`.
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


def layer_norm_post_plain(h: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version of the post mode, the same contract: the
    statistics, the normalisation, the affine map and the add in float32,
    h rounded once."""
    _check(x, w, b, h)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps) * w.float() + b.float()
    h.copy_((h.float() + y).to(h.dtype))
    return h


def layer_norm_post(h: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, eps: float) -> torch.Tensor:
    """h += LN(x) * w + b as the module docstring says, h and x (M, N) of
    one dtype, w and b (N,). A CUDA x launches the post kernel once: bf16 h
    and x, contiguous, 16-byte aligned and apart, N a multiple of 8 up to
    MAX_FEATURES, w and b float32 and contiguous; a CPU x takes
    :func:`layer_norm_post_plain`. Raises on a refused launch."""
    if x.device.type == "cpu":
        return layer_norm_post_plain(h, x, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_post: no kernel for device {x.device}")
    _check(x, w, b, h)
    m, n = x.shape
    if x.dtype != torch.bfloat16 or n % 8 or n > MAX_FEATURES \
            or w.dtype != torch.float32 or b.dtype != torch.float32 \
            or h.data_ptr() == x.data_ptr() \
            or any(not t.is_contiguous() or t.data_ptr() % 16
                   for t in (h, x, w, b)):
        raise ValueError(f"layer_norm_post: the kernel takes contiguous, "
                         f"16-byte-aligned, distinct bf16 rows of a multiple "
                         f"of 8 up to {MAX_FEATURES} and float32 w, b; got x "
                         f"{x.dtype} {tuple(x.shape)}, w {w.dtype}")
    if m == 0:
        return h
    with launch_span("satae.ln", layer_norm, x.dtype, rows=m, post=1):
        _build.launch(_build.load("layernorm"), "satae_layernorm_post_bf16",
                      x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                      h.data_ptr(), m, n, float(eps))
    return h
