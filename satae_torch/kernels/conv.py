"""Eval-mode conv + BatchNorm + activation: kernel K2 and its plain version.

Counterpart of satae/kernels/conv.py (``bn_fold``, ``conv2d_bn_act_infer``).
The JAX version builds an im2col matrix in XLA and runs the Pallas GEMM on
it; K2 (satae_torch/csrc/conv_bn_act.cu) is an implicit GEMM that gathers the
patches in its loads and never writes an im2col matrix. On a CUDA tensor
:func:`conv2d_bn_act` launches K2; on a CPU tensor it computes
:func:`conv2d_bn_act_plain`. There is no fallback from one to the other.

Layouts are the JAX package's: NHWC activations, HWIO weights. A PyTorch
OIHW weight goes through :func:`pack_conv_weight` once, at load, into the
buffer its dtype's kernels read: a contiguous HWIO tensor in bf16; in
float32 a (Cout, KH, KW, Cin) buffer, handed out as its HWIO view (K2's
TF32 wgmma kernels take the weight only K-major, as the tensor cores take
TF32, and its float32 mma.sync loop reads the same buffer), with its TF32
halves (:func:`split_tf32`), which the float32 im2col kernel reads.

x and w are both float32 or both bf16 (K2's bf16 instantiation,
``satae_conv2d_bn_act_bf16``, counted in ``conv2d_bn_act.launches["_bf16"]``),
scale and shift float32; the sums and the epilogue are float32 and the
output is in x's dtype, rounded once, as satae's ``conv2d_bn_act_infer``
computes through ``fused_matmul``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from satae_torch.kernels import _build
from satae_torch.kernels.matmul import (ACTS, apply_act, launch_span,
                                        tile_n_for)


def bn_fold(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5):
    """Eval-mode BN -> (scale, shift) with y = x * scale + shift."""
    scale = weight.float() * torch.rsqrt(var.float() + eps)
    shift = bias.float() - mean.float() * scale
    return scale, shift


def pack_conv_weight(w_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW -> HWIO: row k of its (KH*KW*Cin, Cout) view is tap
    (k // Cin) // KW, (k // Cin) % KW and channel k % Cin, the patch order
    K2 gathers in. In the layout K2 reads in the weight's dtype, and
    nothing else: a contiguous HWIO tensor in bf16, the HWIO
    view of a contiguous (Cout, KH, KW, Cin) buffer in float32 -- the same
    values, each output channel's KH*KW*Cin weights contiguous."""
    w = w_oihw.detach()
    if w.dtype == torch.float32:
        return w.permute(0, 2, 3, 1).contiguous().permute(1, 2, 3, 0)
    return w.permute(2, 3, 1, 0).contiguous()


def is_k_major(w: torch.Tensor) -> bool:
    """Whether the HWIO ``w`` is the view of a contiguous (Cout, KH, KW,
    Cin) buffer."""
    return w.permute(3, 0, 1, 2).is_contiguous()


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the bits, as gemm_tile.cuh's ``to_tf32``: add
    half of the 13 dropped mantissa bits' range to the magnitude, clear
    them."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(w: torch.Tensor) -> torch.Tensor:
    """The TF32 halves of the float32 K-major weight ``w`` (from
    :func:`pack_conv_weight`) that K2's float32 im2col kernel reads: big =
    tf32_rna(v), then small = tf32_rna(v - big), each in the (Cout, KH *
    KW * Cin) order, one (2 * w.numel(),) buffer -- the values the kernels
    split in registers. Made once per weight set, with the fold."""
    if w.dtype != torch.float32 or not is_k_major(w):
        raise ValueError("split_tf32: takes a float32 weight from "
                         "pack_conv_weight")
    v = w.detach().permute(3, 0, 1, 2).reshape(-1)
    big = _tf32(v)
    return torch.cat([big, _tf32(v - big)])


def _out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int):
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def conv2d_bn_act_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, stride: int = 1,
                        padding: int = 0, act: str = "none") -> torch.Tensor:
    """The plain PyTorch version of K2: F.conv2d in float32 (of the bf16
    values, for bf16 operands), then the folded affine and the activation in
    float32. x NHWC, w HWIO; returns NHWC in x's dtype, rounded once."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1) * scale.float() + shift.float()
    return apply_act(y, act).to(x.dtype).contiguous()


# the input rows one tile of K2's staged-rows kernel may keep in shared
# memory, bytes
ROWS_SMEM = 64 * 1024


def conv_route(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> Tuple[str, int]:
    """K2's kernel for NHWC x and HWIO w: (route, tile_n), a fixed function
    of dtype, shape and alignment. For bf16 or float32 with x and w 16-byte
    aligned, on wgmma: "rows" (tile_n 32), the staged-rows kernel, for a
    conv0-like layer -- K = KH * KW * Cin <= 32, Cout <= 32 and a multiple
    of 8, 128 output pixels that are whole output rows of one image, input
    rows of a multiple of 16 bytes; "im2col", the kernel whose patches and
    weight come by TMA, for stride <= 8 and filter and padding <= 64
    (TMA's im2col mode) and -- bf16, Cout a multiple of 8 -- either Cout <=
    64 with Cin a multiple of 32 (tile_n 64, loads of 32 channels) or Cin a
    multiple of 64 (tile_n 128, loads of 64); float32 (3xTF32), Cin a
    multiple of 32 (one load of 32 channels of a tap per 32-deep stage),
    tile_n 64 (a 128-wide split weight per warpgroup would not fit beside
    the ring). Everything else: "mma", gemm_tile.cuh's mma.sync loop,
    tile_n 32 or 64 -- channel counts TMA's im2col cannot cut into whole
    stages (bf16 Cin 5, 6, 8, 16; float32 Cin 5 or 40), misaligned
    buffers. Every route reads the weight in the one layout of its dtype
    (:func:`pack_conv_weight`)."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    oh, ow = _out_hw(h, wd, kh, kw, stride, padding)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    esize = x.element_size()
    if aligned and cout % 8 == 0:
        rows = ((128 // ow - 1) * stride + kh) * wd * cin * esize if \
            0 < ow <= 128 else 0
        if (kh * kw * cin <= 32 and cout <= 32 and 0 < ow <= 128
                and 128 % ow == 0 and oh * ow % 128 == 0
                and wd * cin * esize % 16 == 0 and rows <= ROWS_SMEM):
            return "rows", 32
        # TMA's im2col mode walks windows in strides of at most 8, from
        # corners within 8-bit offsets of the image
        if stride <= 8 and max(kh, kw, padding) <= 64:
            if x.dtype == torch.float32:
                if cin % 32 == 0:
                    return "im2col", 64
            elif cout <= 64 and cin % 32 == 0:
                return "im2col", 64
            elif cin % 64 == 0:
                return "im2col", 128
    return "mma", tile_n_for(cout)


def _conv_cuda(x, w, scale, shift, stride, padding, act, w_tf32):
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    oh, ow = _out_hw(h, wd, kh, kw, stride, padding)
    route, tile_n = conv_route(x, w, stride, padding)
    f32 = x.dtype == torch.float32
    # the buffer K2 reads (pack_conv_weight): (Cout, KH, KW, Cin) in
    # float32, HWIO in bf16
    w_buf = w.permute(3, 0, 1, 2) if f32 else w
    if not w_buf.is_contiguous():
        raise ValueError("conv2d_bn_act: the weight is not in the layout K2 "
                         f"reads in {w.dtype} (pack_conv_weight)")
    f32_im2col = f32 and route == "im2col"
    if f32_im2col and (w_tf32 is None or w_tf32.shape != (2 * w.numel(),)
                       or w_tf32.dtype != torch.float32
                       or w_tf32.device != x.device
                       or not w_tf32.is_contiguous()):
        raise ValueError("conv2d_bn_act: the float32 im2col kernel reads "
                         "w_tf32 = split_tf32(w), beside x")
    suffix = _build.check_operands("conv2d_bn_act", x.device, x, w_buf,
                                   scale=scale, shift=shift)
    if max(x.numel(), n * oh * ow * cout) >= 2 ** 31:
        raise ValueError(f"conv2d_bn_act: input {tuple(x.shape)} exceeds "
                         "int32 indexing")
    out = torch.empty((n, oh, ow, cout), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    ptrs = [x.data_ptr(), w_buf.data_ptr()]
    if f32 and route != "mma":
        ptrs.append(w_tf32.data_ptr() if f32_im2col else 0)
    with launch_span("satae.k2", conv2d_bn_act, x.dtype):
        _build.launch(_build.load("conv_bn_act"), "satae_conv2d_bn_act"
                      + suffix + ("" if route == "mma" else "_tma"), x.device,
                      *ptrs, scale.data_ptr(), shift.data_ptr(),
                      out.data_ptr(), n, h, wd, cin, kh, kw, cout, oh, ow,
                      stride, padding, ACTS.index(act), tile_n)
    return out


def conv2d_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, stride: int = 1, padding: int = 0,
                  act: str = "none", *,
                  w_tf32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(conv2d(x, w) * scale + shift) for NHWC x and HWIO w, with the conv
    bias and eval-mode BN folded into scale/shift (Cout,). x and w are both
    float32 or both bf16, scale and shift float32. Returns NHWC in x's
    dtype.

    A CUDA x launches K2 (counted in ``conv2d_bn_act.launches``), which
    reads w in place in the layout :func:`pack_conv_weight` gives its dtype
    and raises on another; in float32 it takes ``w_tf32 = split_tf32(w)``
    too, which its im2col kernel reads (``conv_route``'s "im2col"; it
    raises without it). A CPU x takes :func:`conv2d_bn_act_plain`, in
    either layout."""
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
        return _conv_cuda(x, w, scale, shift, stride, padding, act, w_tf32)
    if x.device.type == "cpu":
        _build.check_dtypes("conv2d_bn_act", x, w, scale, shift)
        return conv2d_bn_act_plain(x, w, scale, shift, stride, padding, act)
    raise ValueError(f"conv2d_bn_act: no kernel for device {x.device}")


conv2d_bn_act.launches = _build.launch_counter()
