"""Hand-written Hopper kernels of the serving path, each beside its plain
PyTorch version: K1 ``fused_matmul`` (csrc/fused_gemm.cu) and K2
``conv2d_bn_act`` (csrc/conv_bn_act.cu). A CUDA tensor launches the kernel,
a CPU tensor takes the plain version."""

from __future__ import annotations

from typing import Dict

from satae_torch.kernels.conv import conv2d_bn_act
from satae_torch.kernels.matmul import fused_matmul

_WRAPPERS = {"fused_gemm": fused_matmul, "conv2d_bn_act": conv2d_bn_act}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
