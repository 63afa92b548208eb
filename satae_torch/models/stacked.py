"""Config-batched models for the vmap sweep engine: the counterpart of
satae's models under ``jax.vmap`` over a config axis
(satae/train/vmap_sweep.py:66-70, :223-226).

:class:`StackedSupervisedAE` and :class:`StackedMLP` are the single-config
modules (satae_torch.models.supervised_ae, .mlp) with every parameter and
buffer stacked on a leading (C,) axis: the state_dict has the reference
keys, each value one slice per config (``num_batches_tracked`` is (C,)).
``config(i)`` is config i's reference state_dict, which the sweep
checkpoints in satae's format; ``set_config(i, sd)`` loads one. The
forwards run satae_torch.nn.stacked: grouped convolutions over folded
(B, C * ch, H, W) activations, per-config BatchNorm, and the batched K1
for every linear layer.

Init: config i starts from the weights the sequential engine gives the
config it trains with seed ``seed + i`` (satae_torch.train.fast_loop:
PyTorch's default init drawn by ``init_`` from
``torch.Generator().manual_seed(seed + i)``), so both engines start config
i from the same weights. satae draws its configs from
``jax.random.split(PRNGKey(seed), C)``, a stream the port cannot
reproduce (satae_torch.nn.init); the bounds are the same.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from satae_torch.config import ModelConfig
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn import layers as L
from satae_torch.nn import stacked as S
from satae_torch.nn.init import init_

StateDict = Dict[str, torch.Tensor]


def _stack_(model: nn.Module, n: int) -> None:
    """Replace every parameter and buffer of ``model`` by n copies of it on
    a new leading axis."""
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, nn.Parameter(
                p.detach().unsqueeze(0).repeat(n, *[1] * p.dim())))
        for name, b in list(mod.named_buffers(recurse=False)):
            mod.register_buffer(name,
                                b.unsqueeze(0).repeat(n, *[1] * b.dim()))


class _Stacked:
    """config(i) / set_config(i, sd) / init for a stacked module."""

    n_configs: int

    def config(self, i: int) -> StateDict:
        """Config i's reference state_dict (copies)."""
        return {k: v[i].detach().clone() for k, v in self.state_dict().items()}

    @torch.no_grad()
    def set_config(self, i: int, sd: StateDict) -> None:
        """Load a reference state_dict into config i."""
        own = self.state_dict()
        if set(sd) != set(own):
            raise KeyError("state_dict keys differ: "
                           f"{sorted(set(sd) ^ set(own))}")
        for k, v in own.items():
            v[i].copy_(sd[k])

    def init_configs(self, seed: int) -> "_Stacked":
        """Config i <- ``init_`` of a single-config model with
        ``torch.Generator().manual_seed(seed + i)`` (the module docstring)."""
        for i in range(self.n_configs):
            single = self.single()
            init_(single, torch.Generator().manual_seed(seed + i))
            self.set_config(i, single.state_dict())
        return self


class StackedSupervisedAE(SupervisedAE, _Stacked):
    def __init__(self, cfg: ModelConfig, n_configs: int, in_ch: int = 3,
                 image_size: int = 64):
        super().__init__(cfg, in_ch, image_size)
        self._args = (cfg, in_ch, image_size)
        self.n_configs = n_configs
        _stack_(self, n_configs)

    def single(self) -> SupervisedAE:
        return SupervisedAE(*self._args)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Folded images (B, C*in_ch, H, W) -> latents (C, B, latent)."""
        h = x
        for conv, bn in self.enc.blocks():
            h = S.conv2d(h, conv.weight, conv.bias, conv.stride[0],
                         conv.padding[0])
            h = torch.relu(S.bn(h, bn))
        b = h.shape[0]
        # each config's (ch, h, w) block flattened in the reference's order
        h = h.reshape(b, self.n_configs, -1).transpose(0, 1)
        return S.linear(h, self.enc.proj.weight, self.enc.proj.bias)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (C, B, latent) -> folded x_hat (B, C*out_ch, H, W)."""
        dec = self.dec
        h = S.linear(z, dec.decoder_input.weight, dec.decoder_input.bias)
        c, b = h.shape[:2]
        h = h.reshape(c, b, dec.c0, dec.spatial, dec.spatial).transpose(0, 1)
        h = h.reshape(b, c * dec.c0, dec.spatial, dec.spatial)
        for ct, bn in dec.blocks():
            h = S.conv_transpose2d(h, ct.weight, ct.bias, ct.stride[0],
                                   ct.padding[0], ct.output_padding[0])
            if bn is not None:
                h = torch.relu(S.bn(h, bn))
        return torch.sigmoid(h)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Folded images (B, C*in_ch, H, W) -> (folded x_hat, logits
        (C, B, classes), z (C, B, latent))."""
        z = self.encode(x)
        fc1, fc2 = self.classifier[0], self.classifier[2]
        h = S.linear(z, fc1.weight, fc1.bias, "relu")
        return self.decode(z), S.linear(h, fc2.weight, fc2.bias), z


class StackedMLP(MLP, _Stacked):
    def __init__(self, cfg: ModelConfig, n_configs: int,
                 input_dim: Optional[int] = None):
        super().__init__(cfg, input_dim)
        self._args = (cfg, input_dim)
        self.n_configs = n_configs
        _stack_(self, n_configs)

    def single(self) -> MLP:
        return MLP(*self._args)

    def forward(self, z: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Latents (C, B, input_dim) -> logits (C, B, classes). In train
        mode the dropout keep mask (C, B, hidden[0]) is ``dropout_mask`` or
        drawn from ``generator`` (:func:`satae_torch.nn.stacked.keep_mask`)."""
        h = z
        for i, (fc, bn) in enumerate(self.hidden()):
            h = S.linear(h, fc.weight, fc.bias)
            h = torch.relu(S.bn(h, bn))
            if i == 0 and self.training and self.dropout_rate:
                if dropout_mask is None:
                    dropout_mask = S.keep_mask(h.shape, self.dropout_rate,
                                               generator, h.device)
                h = L.dropout(h, self.dropout_rate, dropout_mask)
        return S.linear(h, self.out.weight, self.out.bias)
