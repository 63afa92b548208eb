"""Eval-mode layers: the counterpart of satae/nn/layers.py.

Activations are NHWC, as in satae, so that each layer compares with its JAX
counterpart on the same arrays. Weights are in PyTorch's layout, the one the
reference state_dicts use: conv OIHW, transposed conv (in, out, kh, kw),
linear (out, in). The models (satae_torch.models) hold those weights in
``nn.Conv2d``/``nn.BatchNorm*``/``nn.Linear`` modules for the state_dict keys
and compute their forward through these functions.

Training-mode BatchNorm, dropout and the initialisers come with the training
slice (ROADMAP.md §1 item 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b with w stored (out, in)."""
    return F.linear(x, w, b)


relu = torch.relu
sigmoid = torch.sigmoid
