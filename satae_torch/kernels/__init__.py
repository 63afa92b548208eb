"""Hand-written Hopper kernels, each beside its plain PyTorch version: K1
``fused_matmul`` (csrc/fused_gemm.cu) with its backward
``fused_matmul_bwd``, whose products are K1 launches too, both also over a
leading config axis in one launch, which the config-batched sweep's
linears run on, and K2 ``conv2d_bn_act`` (csrc/conv_bn_act.cu), each with
a float32 and a bf16 instantiation, K1's wide kernel for the ViT
encoder's large bf16 products (``fused_gemm_wide``, csrc/gemm_wide.cu);
the ViT encoder's bf16 ``attention`` (csrc/attention.cu) and
``layer_norm`` (csrc/layernorm.cu; its post mode ``layer_norm_post`` for
the Swin encoder); and the Swin encoder's bf16 ``window_attention``
(csrc/window_attention.cu). A CUDA tensor launches the kernel, a CPU
tensor takes the plain version."""

from __future__ import annotations

from typing import Dict

from satae_torch.kernels.attention import attention
from satae_torch.kernels.conv import conv2d_bn_act
from satae_torch.kernels.layernorm import layer_norm, layer_norm_post
from satae_torch.kernels.matmul import (fused_gemm_wide, fused_matmul,
                                        fused_matmul_bwd)
from satae_torch.kernels.window_attention import window_attention

# each name of launch_counts: the wrapper and its counter; K1's two
# wrappers count their launches over a config axis apart
_COUNTERS = {"fused_gemm": (fused_matmul, "launches"),
             "fused_gemm_bwd": (fused_matmul_bwd, "launches"),
             "conv2d_bn_act": (conv2d_bn_act, "launches"),
             "fused_gemm_batched": (fused_matmul, "batched_launches"),
             "fused_gemm_batched_bwd": (fused_matmul_bwd, "batched_launches"),
             "attention": (attention, "launches"),
             "layer_norm": (layer_norm, "launches"),
             "fused_gemm_wide": (fused_gemm_wide, "launches"),
             "window_attention": (window_attention, "launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`:
    ``fused_gemm`` counts K1's float32 forward launches, ``fused_gemm_bwd``
    the float32 K1 launches of its backward, ``conv2d_bn_act`` K2's float32
    launches, ``fused_gemm_batched`` and ``fused_gemm_batched_bwd`` K1's
    float32 launches over a config axis forward and backward, and each name
    with ``_bf16`` the launches of the bf16 instantiation (``attention``,
    ``layer_norm``, its post mode counted too, and ``window_attention``
    have only that one); ``fused_gemm_wide_bf16`` counts the
    K1 launches of ``fused_gemm`` and ``fused_gemm_bwd`` that ran K1's wide
    kernel (bf16 only), which those two names count too."""
    return {name + suffix: n for name, (fn, attr) in _COUNTERS.items()
            for suffix, n in getattr(fn, attr).items()}


def reset_launch_counts() -> None:
    for fn, attr in _COUNTERS.values():
        setattr(fn, attr, dict.fromkeys(getattr(fn, attr), 0))
