"""Hand-written Hopper kernels, each beside its plain PyTorch version: K1
``fused_matmul`` (csrc/fused_gemm.cu) with its backward
``fused_matmul_bwd``, whose products are K1 launches too, and K2
``conv2d_bn_act`` (csrc/conv_bn_act.cu), each with a float32 and a bf16
instantiation. A CUDA tensor launches the kernel, a CPU tensor takes the
plain version."""

from __future__ import annotations

from typing import Dict

from satae_torch.kernels.conv import conv2d_bn_act
from satae_torch.kernels.matmul import fused_matmul, fused_matmul_bwd

_WRAPPERS = {"fused_gemm": fused_matmul, "fused_gemm_bwd": fused_matmul_bwd,
             "conv2d_bn_act": conv2d_bn_act}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`:
    ``fused_gemm`` counts K1's float32 forward launches, ``fused_gemm_bwd``
    the float32 K1 launches of its backward, ``conv2d_bn_act`` K2's float32
    launches, and each name with ``_bf16`` the launches of the bf16
    instantiation."""
    return {name + suffix: n for name, fn in _WRAPPERS.items()
            for suffix, n in fn.launches.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = dict.fromkeys(fn.launches, 0)
