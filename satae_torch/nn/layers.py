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

bf16 compute follows satae's layers: the parameters stay float32 (the
master copy) and each layer casts them to the activation's dtype at use
(layers.py:55,60, :102,115, :237-241, :260-261), so the casts' backward
hands float32 gradients to the parameters. The arithmetic is then the
activation's: a bf16 conv or transposed conv rounds its product and then
its bias add, BatchNorm normalises in bf16 (train mode takes its moments in
float32 first), and satae's weakly typed constants (eps, the unbiased
variance factor) are rounded to bf16 before they meet a bf16 tensor. No
``torch.autocast``: its per-op policy (BatchNorm in float32, its own cast
points) is not satae's arithmetic. One difference is kept on purpose:
satae's training-time ``linear`` is XLA's dot with a bf16 result plus a
bf16 bias, two roundings, while :func:`linear` runs K1, which rounds once
after its float32 epilogue, as satae's ``_mm_kernel`` does. The tests'
tolerances cover it (tests/test_torch_port_bf16.py).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from satae_torch.kernels.matmul import apply_act, fused_matmul


def float32_convs(deterministic: bool = False):
    """A context in which cuDNN computes convolutions in float32, as satae
    does: PyTorch's default (``cudnn.allow_tf32``) rounds their operands to
    TF32. With ``deterministic`` cuDNN also takes its deterministic
    algorithms: its default choice for the float32 transposed convolutions
    sums in an order that changes between calls (by up to 1.2e-7 on ~1.4 %
    of the decoded pixels on an H100). Every entry point that
    runs a convolution enters it with ``deterministic`` (fit, decode and
    reconstruct, calibration), so each repeats bit for bit as satae's XLA
    programs do; the caller's flags come back on exit."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=deterministic or cudnn.deterministic,
                       allow_tf32=False)


def const_like(v: float, x: torch.Tensor):
    """A constant as satae's weakly typed ones meet x: rounded to x's dtype
    first (PyTorch would take a Python float into a bf16 op unrounded)."""
    return v if x.dtype == torch.float32 else torch.tensor(v, dtype=x.dtype)


def _with_bias(conv, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               **kw) -> torch.Tensor:
    """conv(x, w) + b with w and b cast to x's dtype; in bf16 the product
    and the bias add round apart, as satae's two XLA ops do."""
    if x.dtype == torch.float32:
        return conv(x, w, b, **kw)
    return conv(x, w.to(x.dtype), **kw) + b.to(x.dtype)[:, None, None]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC x, OIHW w -> NHWC in x's dtype; torch.nn.Conv2d semantics."""
    y = _with_bias(F.conv2d, x.permute(0, 3, 1, 2), w, b, stride=stride,
                   padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 2, padding: int = 1,
                     output_padding: int = 1) -> torch.Tensor:
    """NHWC x, (in, out, kh, kw) w -> NHWC in x's dtype;
    torch.nn.ConvTranspose2d semantics (k3/s2/p1/op1 doubles H and W)."""
    y = _with_bias(F.conv_transpose2d, x.permute(0, 3, 1, 2), w, b,
                   stride=stride, padding=padding,
                   output_padding=output_padding)
    return y.permute(0, 2, 3, 1)


def batchnorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm over the last (channel) axis with running stats,
    in satae's order of operations, in x's dtype."""
    dt = x.dtype
    y = (x - mean.to(dt)) * torch.rsqrt(var.to(dt) + const_like(eps, x))
    return y * weight.to(dt) + bias.to(dt)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward sums the cotangents over it
    again: each rank's activations then receive the gradient of every
    rank's loss through the shared batch statistics."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


# (process group, its size) while a data-parallel train step runs: the
# train-mode BatchNorm of every module takes its moments over the group
_BN_GROUP = contextvars.ContextVar("satae_torch_bn_group", default=None)


@contextlib.contextmanager
def synced_batchnorm(mesh):
    """Within it, :func:`bn` in train mode takes global-batch moments over
    ``mesh``'s data axis (satae_torch.parallel.Mesh; None: no change)."""
    token = _BN_GROUP.set(None if mesh is None
                          else (mesh.group, mesh.data_size))
    try:
        yield
    finally:
        _BN_GROUP.reset(token)


def batchnorm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    momentum: float = 0.1, eps: float = 1e-5,
                    group=None) -> torch.Tensor:
    """Train-mode BatchNorm over the last (channel) axis in satae's
    arithmetic (layers.py:219-242): one-pass float32 moments,
    var = max(E[x^2] - E[x]^2, 0), cast to x's dtype, normalisation with
    that biased variance in x's dtype, and the running stats updated in
    place with the unbiased variance var * n / (n - 1). Gradients flow
    through the batch moments.

    ``group``, (process group, size), makes the moments the global batch's,
    as satae's are under GSPMD: each rank's float32 E[x] and E[x^2] are
    summed over the group (differentiably) and divided by its size, and n
    is the global count. Every rank holds an equal share of the batch, which
    the data-parallel steps ensure, so that mean of means is the global
    mean; a group of one gives the arithmetic without a group bit for bit.

    Not ``F.batch_norm(training=True)``: its moments come from another
    algorithm (Welford), which rounds differently."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    mean32 = xf.mean(axes)
    m2 = (xf * xf).mean(axes)
    n = x.numel() // x.shape[-1]
    if group is not None:
        pg, size = group
        moments = _AllReduceSum.apply(torch.stack([mean32, m2]), pg) / size
        mean32, m2 = moments[0], moments[1]
        n *= size
    var32 = torch.clamp(m2 - mean32 * mean32, min=0.0)
    mean, var = mean32.to(x.dtype), var32.to(x.dtype)
    with torch.no_grad():
        unbiased = var * const_like(n / max(n - 1, 1), x)
        running_mean.copy_((1 - momentum) * running_mean
                           + momentum * mean.to(running_mean.dtype))
        running_var.copy_((1 - momentum) * running_var
                          + momentum * unbiased.to(running_var.dtype))
    y = (x - mean) * torch.rsqrt(var + const_like(eps, x))
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def bn(x: torch.Tensor, module: nn.modules.batchnorm._BatchNorm
       ) -> torch.Tensor:
    """``module``'s BatchNorm on NHWC/NC x: batch statistics and a running
    stats update in train mode (as nn.BatchNorm, ``num_batches_tracked``
    counts the updates; global-batch statistics within
    :func:`synced_batchnorm`), running statistics in eval mode."""
    if module.training:
        module.num_batches_tracked.add_(1)
        return batchnorm_train(x, module.weight, module.bias,
                               module.running_mean, module.running_var,
                               module.momentum, module.eps,
                               _BN_GROUP.get())
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
    scale 1 (None: nothing allocated) and shift = b, in x's dtype (w and b
    cast to it, the shift handed to K1 in float32). One K1 launch forward
    on a CUDA x, and K1 launches for its gradients; the plain versions on a
    CPU x."""
    return fused_matmul(x, w.to(x.dtype), None, b.to(x.dtype).float(), act,
                        w_nk=True)


def linear_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 act: str = "none") -> torch.Tensor:
    """:func:`linear` on stock PyTorch ops (``F.linear``, cuBLAS on the
    card): the reference K1 is held against, never the main path. In bf16
    it is satae's training-time ``linear``: the product rounded, then the
    bias add."""
    if x.dtype == torch.float32:
        return apply_act(F.linear(x, w, b), act)
    return apply_act(F.linear(x, w.to(x.dtype)) + b.to(x.dtype), act)


relu = torch.relu
sigmoid = torch.sigmoid
