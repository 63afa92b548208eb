"""Eval-mode conv + BatchNorm + activation: kernel K2 and its plain version.

Counterpart of satae/kernels/conv.py (``bn_fold``, ``conv2d_bn_act_infer``).
The JAX version builds an im2col matrix in XLA and runs the Pallas GEMM on
it; K2 (satae_torch/csrc/conv_bn_act.cu) is an implicit GEMM that gathers the
patches in its loads and never writes an im2col matrix. On a CUDA tensor
:func:`conv2d_bn_act` launches K2; on a CPU tensor it computes
:func:`conv2d_bn_act_plain`. There is no fallback from one to the other.

Layouts are the JAX package's: NHWC activations, HWIO weights. A PyTorch
OIHW weight goes through :func:`pack_conv_weight` once, at load.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from satae_torch.kernels import _build
from satae_torch.kernels.matmul import ACTS, apply_act, tile_n_for


def bn_fold(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5):
    """Eval-mode BN -> (scale, shift) with y = x * scale + shift."""
    scale = weight.float() * torch.rsqrt(var.float() + eps)
    shift = bias.float() - mean.float() * scale
    return scale, shift


def pack_conv_weight(w_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW -> contiguous HWIO: row k of its (KH*KW*Cin, Cout) view is tap
    (k // Cin) // KW, (k // Cin) % KW and channel k % Cin, the patch order
    K2 gathers in."""
    return w_oihw.detach().permute(2, 3, 1, 0).contiguous()


def _out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int):
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def conv2d_bn_act_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, stride: int = 1,
                        padding: int = 0, act: str = "none") -> torch.Tensor:
    """The plain PyTorch version of K2: F.conv2d, then the folded affine and
    the activation. x NHWC, w HWIO; returns NHWC in x's dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1) * scale.float() + shift.float()
    return apply_act(y, act).to(x.dtype).contiguous()


def _conv_cuda(x, w, scale, shift, stride, padding, act):
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    oh, ow = _out_hw(h, wd, kh, kw, stride, padding)
    _build.check_operands("conv2d_bn_act", x.device, x=x, w=w, scale=scale,
                          shift=shift)
    if max(x.numel(), n * oh * ow * cout) >= 2 ** 31:
        raise ValueError(f"conv2d_bn_act: input {tuple(x.shape)} exceeds "
                         "int32 indexing")
    out = torch.empty((n, oh, ow, cout), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    _build.launch(_build.load("conv_bn_act"), "satae_conv2d_bn_act", x.device,
                  x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                  shift.data_ptr(), out.data_ptr(), n, h, wd, cin, kh, kw,
                  cout, oh, ow, stride, padding, ACTS.index(act),
                  tile_n_for(cout))
    conv2d_bn_act.launches += 1
    return out


def conv2d_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, stride: int = 1, padding: int = 0,
                  act: str = "none") -> torch.Tensor:
    """act(conv2d(x, w) * scale + shift) for NHWC x and HWIO w, with the conv
    bias and eval-mode BN folded into scale/shift (Cout,). Returns NHWC.

    A CUDA x launches K2 (``conv2d_bn_act.launches`` counts the launches); a
    CPU x takes :func:`conv2d_bn_act_plain`."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d_bn_act: bad shapes x {tuple(x.shape)} "
                         f"(NHWC), w {tuple(w.shape)} (HWIO)")
    cout = w.shape[3]
    if scale.shape != (cout,) or shift.shape != (cout,):
        raise ValueError(f"conv2d_bn_act: scale/shift must be ({cout},)")
    if stride < 1 or padding < 0:
        raise ValueError("conv2d_bn_act: stride >= 1 and padding >= 0")
    if x.device.type == "cuda":
        return _conv_cuda(x, w, scale, shift, stride, padding, act)
    if x.device.type == "cpu":
        return conv2d_bn_act_plain(x, w, scale, shift, stride, padding, act)
    raise ValueError(f"conv2d_bn_act: no kernel for device {x.device}")


conv2d_bn_act.launches = 0
