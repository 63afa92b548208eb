"""Convolutional encoder: the counterpart of satae/models/encoder.py.

4 x (Conv2d k3/s2/p1 + BatchNorm2d + ReLU), channels 3->32->64->128->256,
spatial 64->32->16->8->4, then flatten and Linear(256*4*4 -> latent_dim).
Module names give the reference state_dict keys: ``encoder.{3i}`` conv,
``encoder.{3i+1}`` BN, ``encoder.{3n}`` Flatten, ``encoder.{3n+1}`` Linear.

The forward takes NHWC images like satae, and flattens in the reference's
NCHW order, so the projection weight is the reference's (satae's differs
from it by the permutation in satae/io/torch_export.py). In train mode the
BatchNorm layers normalise with batch statistics and update their running
buffers in satae's arithmetic (satae_torch.nn.layers.bn).

The models' forwards take the linear function as ``linear``: the default is
:func:`satae_torch.nn.layers.linear`, kernel K1 on the card; a reference run
passes ``layers.linear_plain`` to hold K1 against stock PyTorch ops.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from satae_torch.config import ModelConfig
from satae_torch.nn import layers as L


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, in_ch: int = 3, image_size: int = 64):
        super().__init__()
        n = len(cfg.encoder_channels)
        if image_size % (2 ** n) != 0:
            raise ValueError(
                f"image_size={image_size} must be divisible by 2^{n} "
                f"(the {n} stride-2 encoder blocks halve it each time)")
        chans = (in_ch,) + tuple(cfg.encoder_channels)
        mods: List[nn.Module] = []
        for i in range(n):
            mods += [nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1),
                     nn.BatchNorm2d(chans[i + 1], eps=cfg.bn_eps,
                                    momentum=cfg.bn_momentum),
                     nn.ReLU()]
        spatial = image_size // (2 ** n)
        mods += [nn.Flatten(),
                 nn.Linear(chans[-1] * spatial * spatial, cfg.latent_dim)]
        self.encoder = nn.Sequential(*mods)
        self.n_blocks = n

    def blocks(self) -> List[Tuple[nn.Conv2d, nn.BatchNorm2d]]:
        return [(self.encoder[3 * i], self.encoder[3 * i + 1])
                for i in range(self.n_blocks)]

    @property
    def proj(self) -> nn.Linear:
        return self.encoder[3 * self.n_blocks + 1]

    def forward(self, x: torch.Tensor, linear=L.linear) -> torch.Tensor:
        """x: (N, H, W, C) float in [0,1] -> latent (N, latent_dim)."""
        h = x
        for conv, bn in self.blocks():
            h = L.conv2d(h, conv.weight, conv.bias, conv.stride[0],
                         conv.padding[0])
            h = L.relu(L.bn(h, bn))
        h = h.permute(0, 3, 1, 2).flatten(1)
        return linear(h, self.proj.weight, self.proj.bias)
