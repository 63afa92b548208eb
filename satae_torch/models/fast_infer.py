"""The serving path on the kernels: uint8 batch -> latent -> class ids.

Counterpart of satae/models/fast_infer.py. Every conv layer of the encoder
is one K2 launch (conv + bias + eval BatchNorm + ReLU) and every linear layer
one K1 launch (matmul + folded BN/bias + activation), 4 + 4 launches per
chunk at the default config. BN and bias fold exactly as satae's
fast_infer.py:28-47 folds them.

Folding and packing happen once per weight set (:func:`fold_encoder`,
:func:`fold_mlp`), not per call: conv weights go OIHW -> HWIO (the K2 patch
order), linear weights (out, in) -> (in, out), and the encoder projection's
input rows are reordered from the reference's NCHW flatten to the NHWC
flatten of K2's output, the permutation satae/io/torch_import.py applies.
A caller that changes the modules' weights folds again (satae_torch.api
does so when it sees them change).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from satae_torch.data.augment import normalize
from satae_torch.kernels.conv import bn_fold, conv2d_bn_act, pack_conv_weight
from satae_torch.kernels.matmul import fused_matmul
from satae_torch.models.encoder import Encoder
from satae_torch.models.mlp import MLP


@dataclass(frozen=True)
class FoldedConv:
    """One K2 launch: act(conv(x, w) * scale + shift), stride, padding."""
    w: torch.Tensor  # HWIO
    scale: torch.Tensor
    shift: torch.Tensor
    stride: int
    padding: int


@dataclass(frozen=True)
class FoldedLinear:
    """One K1 launch: act((x @ w) * scale + shift)."""
    w: torch.Tensor  # (in, out)
    scale: torch.Tensor
    shift: torch.Tensor
    act: str

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return fused_matmul(h, self.w, self.scale, self.shift, self.act)


@dataclass(frozen=True)
class FoldedEncoder:
    convs: Tuple[FoldedConv, ...]
    proj: FoldedLinear  # rows in the NHWC flatten order of K2's output


@dataclass(frozen=True)
class FoldedMLP:
    layers: Tuple[FoldedLinear, ...]


def _plain_linear(w_in_out: torch.Tensor, b: torch.Tensor) -> FoldedLinear:
    """satae's ``linear_pallas``: scale 1, shift = bias."""
    return FoldedLinear(w_in_out.contiguous(), torch.ones_like(b.float()),
                        b.detach().float(), "none")


@torch.no_grad()
def fold_encoder(enc: Encoder) -> FoldedEncoder:
    convs = []
    for conv, bn in enc.blocks():
        scale, shift = bn_fold(bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, bn.eps)
        # (z + b) * s + t = z * s + (b * s + t)
        shift = shift + conv.bias.float() * scale
        convs.append(FoldedConv(pack_conv_weight(conv.weight), scale, shift,
                                conv.stride[0], conv.padding[0]))
    c = enc.blocks()[-1][0].out_channels
    w = enc.proj.weight.detach()  # (latent, C*S*S), NCHW flatten
    s = int(round((w.shape[1] // c) ** 0.5))
    w = w.reshape(-1, c, s, s).permute(2, 3, 1, 0).reshape(s * s * c, -1)
    return FoldedEncoder(tuple(convs), _plain_linear(w, enc.proj.bias))


@torch.no_grad()
def fold_mlp(mlp: MLP) -> FoldedMLP:
    layers = []
    for fc, bn in mlp.hidden():
        scale, shift = bn_fold(bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, bn.eps)
        shift = shift + fc.bias.float() * scale
        layers.append(FoldedLinear(fc.weight.detach().t().contiguous(),
                                   scale, shift, "relu"))
    layers.append(_plain_linear(mlp.out.weight.detach().t(), mlp.out.bias))
    return FoldedMLP(tuple(layers))


def encoder_infer(fe: FoldedEncoder, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode encoder forward on the kernels. x: NHWC float."""
    h = x.contiguous()
    for c in fe.convs:
        h = conv2d_bn_act(h, c.w, c.scale, c.shift, stride=c.stride,
                          padding=c.padding, act="relu")
    return fe.proj(h.reshape(h.shape[0], -1))


def mlp_infer(fm: FoldedMLP, z: torch.Tensor) -> torch.Tensor:
    """Eval-mode MLP forward (dropout = identity) on the kernels."""
    h = z.contiguous()
    for layer in fm.layers:
        h = layer(h)
    return h


def make_encode_classify(enc: Encoder, mlp: MLP
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 NHWC images -> predicted classes, every layer on the kernels.
    The weights are folded now: build again after changing them."""
    fe, fm = fold_encoder(enc), fold_mlp(mlp)

    @torch.no_grad()
    def run(imgs_u8: torch.Tensor) -> torch.Tensor:
        z = encoder_infer(fe, normalize(imgs_u8))
        return torch.argmax(mlp_infer(fm, z), dim=-1)

    return run
