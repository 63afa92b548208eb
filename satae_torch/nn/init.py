"""PyTorch-default initialisers, drawn from an explicit generator: the
counterpart of satae/nn/init.py.

PyTorch's default for Conv2d, ConvTranspose2d and Linear is
``kaiming_uniform_(a=sqrt(5))``, which is W ~ U(-1/sqrt(fan_in),
1/sqrt(fan_in)), with the bias drawn from the same bound. The fans are
satae's (satae/nn/init.py:28-64, layers.py:42-74): ``in * k * k`` for a
conv, ``out * k * k`` for a transposed conv (PyTorch takes dim 1 of its
(in, out, kh, kw) weight), ``in_features`` for a linear layer. BatchNorm
starts at weight 1, bias 0, running mean 0 and variance 1.

The values come from a ``torch.Generator``, so they are not satae's (JAX's
threefry stream); the bounds are.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def fan_in(module: nn.Module) -> int:
    """The fan that sets the init bound of ``module``'s weight and bias."""
    if isinstance(module, nn.ConvTranspose2d):
        return module.out_channels * math.prod(module.kernel_size)
    if isinstance(module, nn.Conv2d):
        return module.in_channels * math.prod(module.kernel_size)
    if isinstance(module, nn.Linear):
        return module.in_features
    raise TypeError(f"no default init for {type(module).__name__}")


def default_bounds(model: nn.Module) -> Dict[str, float]:
    """Parameter name -> b of its U(-b, b) draw, for every weight and bias
    of the model's conv, transposed-conv and linear layers."""
    bounds = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            b = 1.0 / math.sqrt(fan_in(mod))
            for p_name, _ in mod.named_parameters(recurse=False):
                bounds[f"{name}.{p_name}" if name else p_name] = b
    return bounds


@torch.no_grad()
def init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` in place, in ``named_parameters``
    order, from ``generator`` (on the parameters' device); reset BatchNorm
    weights and running statistics. Returns the model."""
    bounds = default_bounds(model)
    for name, p in model.named_parameters():
        if name in bounds:
            p.uniform_(-bounds[name], bounds[name], generator=generator)
    for mod in model.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()  # weight 1, bias 0, mean 0, var 1
    return model
