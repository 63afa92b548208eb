"""Supervised autoencoder: the counterpart of satae/models/supervised_ae.py.

``enc`` (Encoder) + ``dec`` (Decoder) + ``classifier`` (Linear -> ReLU ->
Linear, the internal head), the reference's module names, so its
``AE_GLOBAL_BEST.pt`` state_dict loads ``strict=True``. ``forward`` returns
``(x_hat, logits, z)``; x and x_hat are NHWC. The head's Linear + ReLU is
one ``linear(..., act="relu")``, one K1 launch on the card, as satae's
``linear_pallas(z, w, b, "relu")``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from satae_torch.config import ModelConfig
from satae_torch.models.decoder import Decoder
from satae_torch.models.encoder import Encoder
from satae_torch.nn import layers as L


class SupervisedAE(nn.Module):
    def __init__(self, cfg: ModelConfig, in_ch: int = 3, image_size: int = 64):
        super().__init__()
        self.enc = Encoder(cfg, in_ch, image_size)
        self.dec = Decoder(cfg, in_ch, image_size)
        self.classifier = nn.Sequential(
            nn.Linear(cfg.latent_dim, cfg.head_hidden), nn.ReLU(),
            nn.Linear(cfg.head_hidden, cfg.num_classes))

    def forward(self, x: torch.Tensor, linear=L.linear
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        z = self.enc(x, linear)
        fc1, fc2 = self.classifier[0], self.classifier[2]
        h = linear(z, fc1.weight, fc1.bias, "relu")
        return self.dec(z, linear), linear(h, fc2.weight, fc2.bias), z
