"""Transposed-conv decoder: the counterpart of satae/models/decoder.py.

Linear(latent -> 256*4*4), unflatten (NCHW, as the reference), then 4
ConvTranspose2d(k3, s2, p1, output_padding 1) blocks 256->128->64->32->3,
BN + ReLU after the first three, final sigmoid. Module names give the
reference keys: ``decoder_input``, ``decoder.{3i+1}`` ConvTranspose2d,
``decoder.{3i+2}`` BN. It trains with the autoencoder and serves
``SatAEPipeline.decode``/``reconstruct`` (satae_torch.train.extract's
``make_decode_step``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from satae_torch.config import ModelConfig
from satae_torch.nn import layers as L


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, out_ch: int = 3,
                 image_size: int = 64):
        super().__init__()
        rev = tuple(reversed(cfg.encoder_channels))
        chans = rev + (out_ch,)
        n = len(rev)
        self.spatial = image_size // (2 ** n)
        self.decoder_input = nn.Linear(cfg.latent_dim,
                                       rev[0] * self.spatial * self.spatial)
        mods: List[nn.Module] = [
            nn.Unflatten(1, (rev[0], self.spatial, self.spatial))]
        for i in range(n):
            mods.append(nn.ConvTranspose2d(chans[i], chans[i + 1], 3, stride=2,
                                           padding=1, output_padding=1))
            if i < n - 1:
                mods += [nn.BatchNorm2d(chans[i + 1], eps=cfg.bn_eps,
                                        momentum=cfg.bn_momentum),
                         nn.ReLU()]
        mods.append(nn.Sigmoid())
        self.decoder = nn.Sequential(*mods)
        self.n_blocks = n
        self.c0 = rev[0]

    def blocks(self) -> List[Tuple[nn.ConvTranspose2d,
                                   Optional[nn.BatchNorm2d]]]:
        return [(self.decoder[3 * i + 1],
                 self.decoder[3 * i + 2] if i < self.n_blocks - 1 else None)
                for i in range(self.n_blocks)]

    def forward(self, z: torch.Tensor, linear=L.linear) -> torch.Tensor:
        """z: (N, latent_dim) -> x_hat (N, H, W, C) in [0,1]."""
        h = linear(z, self.decoder_input.weight, self.decoder_input.bias)
        h = h.reshape(-1, self.c0, self.spatial, self.spatial)
        h = h.permute(0, 2, 3, 1)
        for ct, bn in self.blocks():
            h = L.conv_transpose2d(h, ct.weight, ct.bias, ct.stride[0],
                                   ct.padding[0], ct.output_padding[0])
            if bn is not None:
                h = L.relu(L.bn(h, bn))
        return L.sigmoid(h)
