"""External MLP classifier: the counterpart of satae/models/mlp.py.

Linear(in,128)+BatchNorm1d+ReLU+Dropout(0.3) -> Linear(128,64)+BatchNorm1d+
ReLU -> Linear(64, classes), as ``net`` with the reference indices
``net.{0,1,4,5,7}``. In eval mode dropout is the identity; in train mode
its mask is passed in (``dropout_mask``, as the tests inject satae's) or
drawn from ``generator``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from satae_torch.config import ModelConfig
from satae_torch.nn import layers as L


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, input_dim: Optional[int] = None):
        super().__init__()
        dims = ((cfg.latent_dim if input_dim is None else input_dim,)
                + tuple(cfg.mlp_hidden))
        mods: List[nn.Module] = []
        self._hidden_idx = []
        for i in range(len(cfg.mlp_hidden)):
            self._hidden_idx.append(len(mods))
            mods += [nn.Linear(dims[i], dims[i + 1]),
                     nn.BatchNorm1d(dims[i + 1], eps=cfg.bn_eps,
                                    momentum=cfg.bn_momentum),
                     nn.ReLU()]
            if i == 0:  # Dropout after the first hidden block only
                mods.append(nn.Dropout(cfg.mlp_dropout))
        mods.append(nn.Linear(dims[-1], cfg.num_classes))
        self.net = nn.Sequential(*mods)
        self.dropout_rate = cfg.mlp_dropout

    def hidden(self) -> List[Tuple[nn.Linear, nn.BatchNorm1d]]:
        return [(self.net[i], self.net[i + 1]) for i in self._hidden_idx]

    @property
    def out(self) -> nn.Linear:
        return self.net[len(self.net) - 1]

    def forward(self, z: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                linear=L.linear) -> torch.Tensor:
        """z: (N, input_dim) latents -> logits (N, num_classes)."""
        h = z
        for i, (fc, bn) in enumerate(self.hidden()):
            h = linear(h, fc.weight, fc.bias)
            h = L.relu(L.bn(h, bn))
            if i == 0 and self.training:  # after the first block only
                h = L.dropout(h, self.dropout_rate, dropout_mask, generator)
        return linear(h, self.out.weight, self.out.bias)
