"""Layers: the counterpart of satae/nn/layers.py.

Activations are NHWC, as in satae, so that each layer compares with its JAX
counterpart on the same arrays. Weights are in PyTorch's layout, the one the
reference state_dicts use: conv OIHW, transposed conv (in, out, kh, kw),
linear (out, in). The models (satae_torch.models) hold those weights in
``nn.Conv2d``/``nn.BatchNorm*``/``nn.Linear`` modules for the state_dict keys
and compute their forward through these functions.

:func:`linear` is satae's ``linear_pallas``: on a CUDA tensor its forward and
backward run on kernel K1 (satae_torch.kernels.matmul). :func:`linear_plain`
is the same function on stock PyTorch ops, kept as a reference to hold K1
against; no model path selects it by itself. The convolutions stay
``F.conv2d``/``F.conv_transpose2d`` in both directions: satae computes them
in XLA, outside any Pallas kernel, and ``F.conv_transpose2d``'s native
backward is the adjoint satae builds by hand (layers.py:171-192).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from satae_torch.kernels.matmul import apply_act, fused_matmul


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC x, OIHW w -> NHWC; torch.nn.Conv2d semantics."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 2, padding: int = 1,
                     output_padding: int = 1) -> torch.Tensor:
    """NHWC x, (in, out, kh, kw) w -> NHWC; torch.nn.ConvTranspose2d
    semantics (k3/s2/p1/op1 doubles H and W)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=stride,
                           padding=padding, output_padding=output_padding)
    return y.permute(0, 2, 3, 1)


def batchnorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm over the last (channel) axis with running stats,
    in satae's order of operations."""
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * weight + bias


def batchnorm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm over the last (channel) axis in satae's
    arithmetic (layers.py:219-242): one-pass float32 moments,
    var = max(E[x^2] - E[x]^2, 0), normalisation with that biased variance,
    and the running stats updated in place with the unbiased variance
    var * n / (n - 1). Gradients flow through the batch moments.

    Not ``F.batch_norm(training=True)``: its moments come from another
    algorithm (Welford), which rounds differently."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    mean32 = xf.mean(axes)
    m2 = (xf * xf).mean(axes)
    var32 = torch.clamp(m2 - mean32 * mean32, min=0.0)
    mean, var = mean32.to(x.dtype), var32.to(x.dtype)
    n = x.numel() // x.shape[-1]
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        running_mean.copy_((1 - momentum) * running_mean
                           + momentum * mean.to(running_mean.dtype))
        running_var.copy_((1 - momentum) * running_var
                          + momentum * unbiased.to(running_var.dtype))
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * weight + bias


def bn(x: torch.Tensor, module: nn.modules.batchnorm._BatchNorm
       ) -> torch.Tensor:
    """``module``'s BatchNorm on NHWC/NC x: batch statistics and a running
    stats update in train mode (as nn.BatchNorm, ``num_batches_tracked``
    counts the updates), running statistics in eval mode."""
    if module.training:
        module.num_batches_tracked.add_(1)
        return batchnorm_train(x, module.weight, module.bias,
                               module.running_mean, module.running_var,
                               module.momentum, module.eps)
    return batchnorm(x, module.weight, module.bias, module.running_mean,
                     module.running_var, module.eps)


def dropout(x: torch.Tensor, rate: float,
            mask: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (torch semantics: kept values scaled by
    1 / (1 - rate)). ``mask`` (bool, x's shape, True = kept) is used as
    given; without one it is drawn as bernoulli(1 - rate) from
    ``generator`` (satae draws ``bernoulli(key, 1 - rate)``,
    layers.py:274)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           act: str = "none") -> torch.Tensor:
    """act(x @ w.T + b) with w stored (out, in): satae's ``linear_pallas``,
    scale 1 (None: nothing allocated) and shift = b. One K1 launch forward
    on a CUDA x, and K1 launches for its gradients; the plain versions on a
    CPU x."""
    return fused_matmul(x, w, None, b, act, w_nk=True)


def linear_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 act: str = "none") -> torch.Tensor:
    """:func:`linear` on stock PyTorch ops (``F.linear``, cuBLAS on the
    card): the reference K1 is held against, never the main path."""
    return apply_act(F.linear(x, w, b), act)


relu = torch.relu
sigmoid = torch.sigmoid
