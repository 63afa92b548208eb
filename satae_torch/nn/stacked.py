"""Config-batched layers: satae's layers under ``jax.vmap`` over a config
axis (satae/train/vmap_sweep.py), written out as an explicit leading axis.

Every parameter carries a leading (C,) axis, one slice per grid config, in
the reference layout of satae_torch.nn.layers (conv OIHW, transposed conv
(in, out, kh, kw), linear (out, in)). Two activation layouts:

  * the convolutions' NCHW with the config folded into the channels,
    (B, C * ch, H, W), channel block c holding config c, in channels-last
    memory: a convolution is one ``F.conv2d`` / ``F.conv_transpose2d`` with
    ``groups=C`` (cuDNN on the card, as the port's single-config training
    convolutions are), and a BatchNorm over the folded channel axis is per
    config and per channel;
  * the linears' (C, B, features): one launch of K1 over the config axis
    forward (satae_torch.kernels.matmul.fused_matmul) and one each for dX
    and dW backward on the card; its plain version on the CPU.

The arithmetic is satae_torch.nn.layers' per config: bf16 compute casts the
float32 master weights at use, BatchNorm is layers' own over the configs'
channels side by side (one-pass float32 moments, the running stats updated
in place with the unbiased variance), dropout is layers' with a keep mask
per config. Only the summation order inside a reduction differs from the
single-config layers (a grouped convolution, a moment over a folded
layout), so a config's values agree with its single-config run to
rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from satae_torch.kernels.matmul import fused_matmul
from satae_torch.nn import layers as L


def fold(x: torch.Tensor) -> torch.Tensor:
    """Per-config NHWC images (C, B, H, W, ch) -> folded NCHW
    (B, C * ch, H, W)."""
    c, b, h, w, ch = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(b, c * ch, h, w)


def _grouped(conv, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             **kw) -> torch.Tensor:
    """conv(x, w, groups=C) + b for stacked w (C, a, b', kh, kw) and b
    (C, out), in x's dtype; in bf16 the product and the bias add round
    apart, as satae's two XLA ops do (layers._with_bias). x goes in
    channels-last: cuDNN's grouped-convolution kernels are NHWC, and with
    NCHW activations its transposes took 57 % of a stacked AE step's
    device time on an H100 (178 ms a step at C = 45, 106 channels-last)."""
    x = x.contiguous(memory_format=torch.channels_last)
    c = w.shape[0]
    w = w.reshape(c * w.shape[1], *w.shape[2:])
    b = b.reshape(-1)
    if x.dtype == torch.float32:
        return conv(x, w, b, groups=c, **kw)
    return conv(x, w.to(x.dtype), groups=c, **kw) \
        + b.to(x.dtype)[:, None, None]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Folded x (B, C*Cin, H, W), w (C, Cout, Cin, kh, kw), b (C, Cout) ->
    folded (B, C*Cout, H', W'): config c's conv on channel block c."""
    return _grouped(F.conv2d, x, w, b, stride=stride, padding=padding)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 2, padding: int = 1,
                     output_padding: int = 1) -> torch.Tensor:
    """Folded x (B, C*Cin, H, W), w (C, Cin, Cout, kh, kw), b (C, Cout) ->
    folded (B, C*Cout, H', W') with ConvTranspose2d semantics per config."""
    return _grouped(F.conv_transpose2d, x, w, b, stride=stride,
                    padding=padding, output_padding=output_padding)


def _per_channel_last(x: torch.Tensor, n_configs: int):
    """A view of x whose last axis is every config's channels, (..., C *
    ch), for satae_torch.nn.layers' BatchNorm, and the map back: a folded
    NCHW x (B, C*ch, H, W) as NHWC, a (C, B, ch) x as (B, C*ch)."""
    if x.dim() == 4:
        return x.permute(0, 2, 3, 1), lambda y: y.permute(0, 3, 1, 2)
    c, b, ch = x.shape
    return (x.transpose(0, 1).reshape(b, c * ch),
            lambda y: y.reshape(b, c, ch).transpose(0, 1))


def batchnorm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm of every config at once, per config and
    channel: satae_torch.nn.layers.batchnorm_train over the configs'
    channels side by side. x folded NCHW (B, C*ch, H, W) or (C, B, ch);
    weight, bias and the running stats (C, ch), the latter updated in
    place."""
    xl, back = _per_channel_last(x, weight.shape[0])
    return back(L.batchnorm_train(xl, weight.reshape(-1), bias.reshape(-1),
                                  running_mean.view(-1), running_var.view(-1),
                                  momentum, eps))


def batchnorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm of every config with its running stats (C, ch):
    satae_torch.nn.layers.batchnorm over the configs' channels."""
    xl, back = _per_channel_last(x, weight.shape[0])
    return back(L.batchnorm(xl, weight.reshape(-1), bias.reshape(-1),
                            mean.reshape(-1), var.reshape(-1), eps))


def bn(x: torch.Tensor, module: nn.modules.batchnorm._BatchNorm
       ) -> torch.Tensor:
    """A stacked BatchNorm module's forward: batch statistics and a running
    stats update per config in train mode (``num_batches_tracked``, (C,),
    counts the updates), running statistics in eval mode."""
    if module.training:
        module.num_batches_tracked.add_(1)
        return batchnorm_train(x, module.weight, module.bias,
                               module.running_mean, module.running_var,
                               module.momentum, module.eps)
    return batchnorm(x, module.weight, module.bias, module.running_mean,
                     module.running_var, module.eps)


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A dropout keep mask (True = kept) of ``shape``, bernoulli(1 - rate),
    drawn from ``generator``: one slice per config."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           act: str = "none") -> torch.Tensor:
    """act(x[c] @ w[c].T + b[c]) for every config c: x (C, B, in), w
    (C, out, in), b (C, out) -> (C, B, out) in x's dtype, one K1 launch
    over the configs on a CUDA x (and one each for dX and dW in the
    backward), as satae_torch.nn.layers.linear per config."""
    return fused_matmul(x.contiguous(), w.to(x.dtype), None,
                        b.to(x.dtype).float(), act, w_nk=True)
