"""Classic Adam over a list of tensors: the counterpart of
satae/train/optim.py.

betas (0.9, 0.999), eps 1e-8 added after the square root of the
bias-corrected second moment, and ``weight_decay`` as L2 added to the
gradient (not decoupled AdamW), in satae's order of operations
(optim.py:39-45). ``lr`` and ``weight_decay`` are arguments of each update,
so one state serves any config. Not ``torch.optim.Adam``: it puts eps after
sqrt(v) / sqrt(bc2) and folds bc1 into the step size, which rounds
differently. Parameters and moments are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int = 0


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState([torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: AdamState,
                lr: Union[float, torch.Tensor], weight_decay: float = 0.0,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step on ``params`` in place. For C configs stacked on the
    parameters' leading axis (the vmap sweep engine) ``lr`` is a (C,)
    float32 tensor, config c stepping with ``lr[c]`` broadcast on that
    axis; the step counter is shared (the configs step together). Any
    other ``lr`` is taken as ``float(lr)``."""
    state.step += 1
    # the bias corrections in float32, as satae computes them on the device
    t = np.float32(state.step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        g = g + weight_decay * p
        mu.mul_(b1).add_((1.0 - b1) * g)
        nu.mul_(b2).add_((1.0 - b2) * (g * g))
        mhat = mu / bc1
        vhat = nu / bc2
        step = lr.reshape((-1,) + (1,) * (p.dim() - 1)) \
            if isinstance(lr, torch.Tensor) else float(lr)
        p.sub_(step * mhat / (torch.sqrt(vhat) + eps))
