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

In bf16 (``fold_encoder(enc, torch.bfloat16)``) the encoder is served as
satae serves it (api.py:399-415, kernels/conv.py:27-33): its weights, biases
and BatchNorm parameters and stats are cast to bf16 once, scale and shift
are folded in float32 from those bf16 values and stay float32 into K1's and
K2's epilogue, and the activations run in bf16 end to end. The MLP is always
float32: the latents reach it as float32.
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
    """satae's ``linear_pallas``: scale 1, shift = bias (float32 of b's
    values)."""
    return FoldedLinear(w_in_out.contiguous(), torch.ones_like(b.float()),
                        b.detach().float(), "none")


@torch.no_grad()
def fold_encoder(enc: Encoder,
                 dtype: torch.dtype = torch.float32) -> FoldedEncoder:
    """The encoder's K2/K1 launches for activations in ``dtype``: every
    parameter and BatchNorm stat cast to ``dtype`` once, scale and shift
    folded from those values in float32."""
    convs = []
    for conv, bn in enc.blocks():
        scale, shift = bn_fold(*(t.to(dtype) for t in (
            bn.weight, bn.bias, bn.running_mean, bn.running_var)), bn.eps)
        # (z + b) * s + t = z * s + (b * s + t)
        shift = shift + conv.bias.to(dtype).float() * scale
        convs.append(FoldedConv(pack_conv_weight(conv.weight.to(dtype)),
                                scale, shift, conv.stride[0],
                                conv.padding[0]))
    c = enc.blocks()[-1][0].out_channels
    w = enc.proj.weight.detach().to(dtype)  # (latent, C*S*S), NCHW flatten
    s = int(round((w.shape[1] // c) ** 0.5))
    w = w.reshape(-1, c, s, s).permute(2, 3, 1, 0).reshape(s * s * c, -1)
    return FoldedEncoder(tuple(convs),
                         _plain_linear(w, enc.proj.bias.to(dtype)))


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
    """Eval-mode encoder forward on the kernels. x: NHWC, in the dtype
    ``fe`` was folded for; the latents come out in it."""
    h = x.contiguous()
    for c in fe.convs:
        h = conv2d_bn_act(h, c.w, c.scale, c.shift, stride=c.stride,
                          padding=c.padding, act="relu")
    return fe.proj(h.reshape(h.shape[0], -1))


def mlp_infer(fm: FoldedMLP, z: torch.Tensor) -> torch.Tensor:
    """Eval-mode MLP forward (dropout = identity) on the kernels, float32
    latents in."""
    h = z.contiguous()
    for layer in fm.layers:
        h = layer(h)
    return h


def make_encode_classify(enc: Encoder, mlp: MLP,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 NHWC images -> predicted classes, every layer on the kernels,
    the encoder in ``compute_dtype`` and the MLP in float32. The weights are
    folded now: build again after changing them."""
    fe, fm = fold_encoder(enc, compute_dtype), fold_mlp(mlp)

    @torch.no_grad()
    def run(imgs_u8: torch.Tensor) -> torch.Tensor:
        z = encoder_infer(fe, normalize(imgs_u8, compute_dtype))
        return torch.argmax(mlp_infer(fm, z.float()), dim=-1)

    return run
