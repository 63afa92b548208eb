"""The serving path on the kernels: uint8 batch -> latent -> class ids.

Counterpart of satae/models/fast_infer.py. Every conv layer of the encoder
is one K2 launch (conv + bias + eval BatchNorm + ReLU) and every linear layer
one K1 launch (matmul + folded BN/bias + activation), 4 + 4 launches per
chunk at the default config. BN and bias fold exactly as satae's
fast_infer.py:28-47 folds them.

Folding and packing happen once per weight set (:func:`fold_encoder`,
:func:`fold_mlp`), not per call: conv weights go OIHW -> HWIO (the K2 patch
order), and the encoder projection's input rows are reordered from the
reference's NCHW flatten to the NHWC flatten of K2's output, the
permutation satae/io/torch_import.py applies. Each weight's layout follows
its dtype. In float32 every weight is kept K-major, the layout the
kernels' TF32 wgmma reads (the tensor cores take TF32 only K-major):
linear weights stay (out, in), read with ``w_nk``, and conv weights are
the HWIO view of a (Cout, KH, KW, Cin) buffer (:func:`pack_conv_weight`),
with their TF32 halves split once here (:func:`split_tf32`). In bf16 the
encoder's linear weight goes (out, in) -> (in, out) and its conv weights
are contiguous HWIO, which K1's and K2's bf16 wgmma kernels read MN-major.
Either way the values are the same. A caller that changes the modules'
weights folds again (satae_torch.api does so when it sees them change).

A folded encoder serves its family's input by itself: ``fe.host(images)``
checks and converts what a caller passes (:class:`FoldedEncoder`: uint8
images, or floats in [0, 1]; :class:`FoldedViT`: int16 chips of its
config), and ``fe(chunk)`` turns a chunk of it on the device into latents
(:func:`encoder_infer` on the normalised images, :func:`vit_encoder_infer`
on the chips, each looked up when called), so the serving loop, extraction
and the data-parallel step never ask which family they hold.

In bf16 (``fold_encoder(enc, torch.bfloat16)``) the encoder is served as
satae serves it (api.py:399-415, kernels/conv.py:27-33): its weights, biases
and BatchNorm parameters and stats are cast to bf16 once, scale and shift
are folded in float32 from those bf16 values and stay float32 into K1's and
K2's epilogue, and the activations run in bf16 end to end. The MLP is always
float32: the latents reach it as float32.

The ViT encoder (satae_torch.models.vit) is served the same way:
:func:`fold_vit` packs its weights once per weight set and
:func:`vit_encoder_infer` runs a chunk of int16 chips on the kernels. Per
chunk: the patchify and per-band normalisation (PyTorch's copies and
elementwise ops, in the span ``satae.vit.embed``), the patch embedding as
one K1 launch with its bias, the position table added and the class token
set (PyTorch), then per block a LayerNorm launch (the residual add of the
block before it inside), K1 for qkv, one attention launch, K1 for proj, a
LayerNorm launch with the residual add, K1 for fc1 with GELU in its
epilogue and K1 for fc2; a final LayerNorm launch with the last residual
add, and the mean of the patch tokens in float32 (PyTorch). Every Linear is
K1 with scale 1 and its bias as the shift; the residual stream stays in
the compute dtype. On the card the attention and LayerNorm kernels are
bf16 only; on the CPU the plain versions run in float32 or bf16.

The Swin encoder (satae_torch.models.swin) too: :func:`fold_swin` packs its
weights once per weight set, folding each block's continuous position bias
(the CPB MLP on its fixed table, which depends on weights alone) into one
(heads, 64, 64) float32 table and its logit scales into one float32 scalar
a head, and zeroing qkv's k-part bias as torchvision does at every call;
:func:`swin_encoder_infer` runs a chunk of int16 chips on the kernels.
Per chunk: the patchify, per-band scale and clip (PyTorch, in the span
``satae.swin.embed``), the patch embedding as one K1 launch and its
LayerNorm launch; per block K1 for qkv, one window-attention launch (the
shift, the windows and their inverses are the kernel's index arithmetic),
K1 for proj, a post-mode LayerNorm launch adding LN(proj) into the
residual stream, K1 for fc1 with GELU in its epilogue and K1 for fc2, a
post-mode LayerNorm launch; between stages the 2 x 2 merge (one strided
copy in PyTorch, in the span ``satae.swin.merge``), K1 for the reduction
(a zero shift for its missing bias) and a LayerNorm launch; the mean of the
last stage's tokens in float32 (PyTorch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from satae_torch.config import SwinConfig, ViTConfig
from satae_torch.data.augment import normalize
from satae_torch.kernels.attention import attention
from satae_torch.kernels.conv import (bn_fold, conv2d_bn_act,
                                      pack_conv_weight, split_tf32)
from satae_torch.kernels.layernorm import layer_norm, layer_norm_post
from satae_torch.kernels.matmul import fused_matmul
from satae_torch.kernels.window_attention import window_attention
from satae_torch.models.encoder import Encoder
from satae_torch.models.mlp import MLP
from satae_torch.models.swin import SwinEncoder, merge_patches
from satae_torch.models.vit import ViTEncoder
from satae_torch.utils.profiling import span


@dataclass(frozen=True)
class FoldedConv:
    """One K2 launch: act(conv(x, w) * scale + shift), stride, padding;
    in float32 with w's TF32 halves."""
    w: torch.Tensor  # HWIO, laid out by pack_conv_weight
    scale: torch.Tensor
    shift: torch.Tensor
    stride: int
    padding: int
    w_tf32: Optional[torch.Tensor] = None  # split_tf32(w) in float32


@dataclass(frozen=True)
class FoldedLinear:
    """One K1 launch: act((x @ W) * scale + shift), W = w, or w.T with
    ``w_nk``."""
    w: torch.Tensor  # (out, in) in float32, (in, out) otherwise
    scale: torch.Tensor
    shift: torch.Tensor
    act: str

    @property
    def w_nk(self) -> bool:
        """Whether w is the (out, in) buffer: in float32 (K-major)."""
        return self.w.dtype == torch.float32

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        return fused_matmul(h, self.w, self.scale, self.shift, self.act,
                            w_nk=self.w_nk)


@dataclass(frozen=True)
class FoldedEncoder:
    """The autoencoder's encoder folded for the kernels
    (:func:`fold_encoder`): :meth:`host` checks the images a caller
    passes, and calling it on a chunk of them on the device gives the
    latents."""
    convs: Tuple[FoldedConv, ...]
    proj: FoldedLinear  # rows in the NHWC flatten order of K2's output

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype it was folded for."""
        return self.proj.w.dtype

    @staticmethod
    def host(images) -> np.ndarray:
        """The encoder's input on the host: uint8 images, or floats in
        [0,1] rounded back to the uint8 grid. Floats on a 0-255 scale, or
        below 0, are rejected rather than silently saturated."""
        imgs = np.asarray(images)
        if imgs.dtype == np.uint8:
            return imgs
        mx = float(imgs.max(initial=0.0))
        if mx > 1.0 + 1e-3:
            raise ValueError(
                f"float images must be normalized to [0,1] (max={mx:.3g}); "
                "pass uint8 for raw 0-255 pixel values")
        mn = float(imgs.min(initial=0.0))
        if mn < -1e-3:
            raise ValueError(
                f"float images must be normalized to [0,1] (min={mn:.3g}); "
                "[-1,1]-standardized inputs would have every negative pixel "
                "silently clipped to 0")
        return np.rint(np.clip(imgs, 0.0, 1.0) * 255.0).astype(np.uint8)

    def __call__(self, chunk: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC images on the device -> latents in :attr:`dtype`:
        normalised, then :func:`encoder_infer`."""
        return encoder_infer(self, normalize(chunk, self.dtype))


@dataclass(frozen=True)
class FoldedMLP:
    layers: Tuple[FoldedLinear, ...]


def _plain_linear(w_out_in: torch.Tensor, b: torch.Tensor) -> FoldedLinear:
    """satae's ``linear_pallas``: scale 1, shift = bias (float32 of b's
    values), the (out, in) weight kept K-major in float32 and made (in,
    out) otherwise."""
    return FoldedLinear(_linear_weight(w_out_in), torch.ones_like(b.float()),
                        b.detach().float(), "none")


def _linear_weight(w_out_in: torch.Tensor) -> torch.Tensor:
    """The buffer K1 reads for an (out, in) weight: itself in float32 (read
    with ``w_nk``), its (in, out) transpose in bf16."""
    w = w_out_in.detach()
    return (w if w.dtype == torch.float32 else w.t()).contiguous()


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
        w = pack_conv_weight(conv.weight.to(dtype))
        convs.append(FoldedConv(
            w, scale, shift, conv.stride[0], conv.padding[0],
            split_tf32(w) if dtype == torch.float32 else None))
    c = enc.blocks()[-1][0].out_channels
    w = enc.proj.weight.detach().to(dtype)  # (latent, C*S*S), NCHW flatten
    s = int(round((w.shape[1] // c) ** 0.5))
    # (latent, S*S*C): the input axis in the NHWC flatten of K2's output
    w = w.reshape(-1, c, s, s).permute(0, 2, 3, 1).reshape(w.shape[0], -1)
    return FoldedEncoder(tuple(convs),
                         _plain_linear(w, enc.proj.bias.to(dtype)))


@torch.no_grad()
def fold_mlp(mlp: MLP) -> FoldedMLP:
    layers = []
    for fc, bn in mlp.hidden():
        scale, shift = bn_fold(bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, bn.eps)
        shift = shift + fc.bias.float() * scale
        layers.append(FoldedLinear(_linear_weight(fc.weight), scale, shift,
                                   "relu"))
    layers.append(_plain_linear(mlp.out.weight, mlp.out.bias))
    return FoldedMLP(tuple(layers))


def encoder_infer(fe: FoldedEncoder, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode encoder forward on the kernels. x: NHWC, in the dtype
    ``fe`` was folded for; the latents come out in it."""
    h = x.contiguous()
    for c in fe.convs:
        h = conv2d_bn_act(h, c.w, c.scale, c.shift, stride=c.stride,
                          padding=c.padding, act="relu", w_tf32=c.w_tf32)
    return fe.proj(h.reshape(h.shape[0], -1))


def mlp_infer(fm: FoldedMLP, z: torch.Tensor) -> torch.Tensor:
    """Eval-mode MLP forward (dropout = identity) on the kernels, float32
    latents in."""
    h = z.contiguous()
    for layer in fm.layers:
        h = layer(h)
    return h


@dataclass(frozen=True)
class FoldedViTBlock:
    ln1: Tuple[torch.Tensor, torch.Tensor]  # LayerNorm weight, bias (float32)
    qkv: FoldedLinear
    proj: FoldedLinear
    ln2: Tuple[torch.Tensor, torch.Tensor]
    fc1: FoldedLinear  # GELU in its epilogue
    fc2: FoldedLinear


@dataclass(frozen=True)
class FoldedViT:
    """The ViT encoder folded for the kernels (:func:`fold_vit`), served as
    :class:`FoldedEncoder` is: :meth:`host` checks the chips a caller
    passes, and calling it on a chunk of them on the device gives the
    latents."""
    cfg: ViTConfig
    band_mean: torch.Tensor  # (in_chans,) float32
    band_std: torch.Tensor
    patch: FoldedLinear  # (in_chans * tubelet * patch^2 -> embed_dim)
    cls: torch.Tensor  # cls_token + pos_embed[0], (embed_dim,)
    pos: torch.Tensor  # pos_embed[1:], (num_patches, embed_dim)
    blocks: Tuple[FoldedViTBlock, ...]
    norm: Tuple[torch.Tensor, torch.Tensor]

    def host(self, images) -> np.ndarray:
        """The encoder's input on the host: int16 reflectance chips (N,
        bands, frames, H, W) of its config, as they are; any other dtype or
        shape is refused (uint8 images are the autoencoder's)."""
        imgs = np.asarray(images)
        shape = self.cfg.chip_shape
        if imgs.dtype != np.int16:
            raise TypeError(f"the ViT encoder takes int16 reflectance chips "
                            f"(N, {', '.join(map(str, shape))}), got "
                            f"{imgs.dtype}")
        if imgs.ndim != 5 or imgs.shape[1:] != shape:
            raise ValueError(f"chips must be (N, {', '.join(map(str, shape))})"
                             f", got {imgs.shape}")
        return imgs

    def __call__(self, chunk: torch.Tensor) -> torch.Tensor:
        """int16 chips on the device -> float32 latents:
        :func:`vit_encoder_infer`."""
        return vit_encoder_infer(self, chunk)


def _vit_linear(lin: torch.nn.Linear, dtype: torch.dtype,
                act: str = "none") -> FoldedLinear:
    """A ViT Linear as one K1 launch: scale None (1), its bias the shift."""
    return FoldedLinear(_linear_weight(lin.weight.to(dtype)), None,
                        lin.bias.detach().float(), act)


@torch.no_grad()
def fold_vit(enc: ViTEncoder, cfg: ViTConfig,
             dtype: torch.dtype = torch.bfloat16) -> FoldedViT:
    """The encoder's launches for activations in ``dtype``: each weight
    cast to ``dtype`` once and laid out for K1 (the patch projection as its
    (embed_dim, in_chans * tubelet * patch^2) matrix, columns in (band,
    frame, row, column) order), biases and LayerNorm parameters float32, the
    class token and the position table in ``dtype``. ``cfg`` gives the band
    constants."""
    dev = enc.cls_token.device
    ln = lambda m: (m.weight.detach().float().contiguous(),
                    m.bias.detach().float().contiguous())
    w = enc.patch_embed.proj.weight
    patch = FoldedLinear(_linear_weight(w.reshape(w.shape[0], -1).to(dtype)),
                         None, enc.patch_embed.proj.bias.detach().float(),
                         "none")
    pos = enc.pos_embed.detach()[0]
    blocks = tuple(FoldedViTBlock(
        ln(b.norm1), _vit_linear(b.attn.qkv, dtype),
        _vit_linear(b.attn.proj, dtype), ln(b.norm2),
        _vit_linear(b.mlp.fc1, dtype, "gelu"), _vit_linear(b.mlp.fc2, dtype))
        for b in enc.blocks)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return FoldedViT(cfg, f32(cfg.band_mean), f32(cfg.band_std), patch,
                     (enc.cls_token.detach()[0, 0] + pos[0]).to(dtype),
                     pos[1:].to(dtype).contiguous(), blocks, ln(enc.norm))


def vit_patches(fv: FoldedViT, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """int16 chips (n, in_chans, num_frames, H, W) -> the patch matrix (n *
    num_patches, in_chans * tubelet * patch^2) in ``dtype``, each band
    normalised as (x - mean) / std in float32: rows in (t, h, w) order, the
    columns of the Conv3d weight's flatten."""
    c = fv.cfg
    n = len(x)
    gt, gh, gw = c.grid
    p, tb = c.patch_size, c.tubelet_size
    xs = x.view(n, c.in_chans, gt, tb, gh, p, gw, p) \
        .permute(0, 2, 4, 6, 1, 3, 5, 7).float()
    xs.sub_(fv.band_mean.view(-1, 1, 1, 1)).div_(fv.band_std.view(-1, 1, 1, 1))
    out = torch.empty(xs.shape, dtype=dtype, device=x.device)
    out.copy_(xs)
    return out.view(n * c.num_patches, -1)


def vit_encoder_infer(fv: FoldedViT, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode ViT encoder on the kernels, as the module docstring says:
    int16 chips (n, in_chans, num_frames, H, W) -> the mean of the patch
    tokens after the final LayerNorm, (n, embed_dim) float32; the
    activations in the dtype ``fv`` was folded for."""
    c = fv.cfg
    n, d, t = len(x), c.embed_dim, c.num_patches + 1
    dtype = fv.pos.dtype
    with span("satae.vit.embed", device=True):
        patches = vit_patches(fv, x, dtype)
    e = fv.patch(patches).view(n, c.num_patches, d)
    tok = torch.empty((n, t, d), dtype=dtype, device=x.device)
    tok[:, 0] = fv.cls
    torch.add(e, fv.pos, out=tok[:, 1:])
    h, r = tok.view(n * t, d), None
    for blk in fv.blocks:
        h, xn = layer_norm(h, *blk.ln1, c.norm_eps, residual=r)
        a = blk.proj(attention(blk.qkv(xn), n, c.num_heads))
        h, xn = layer_norm(h, *blk.ln2, c.norm_eps, residual=a)
        r = blk.fc2(blk.fc1(xn))
    _, y = layer_norm(h, *fv.norm, c.norm_eps, residual=r)
    return torch.mean(y.view(n, t, d)[:, 1:], dim=1, dtype=torch.float32)


@dataclass(frozen=True)
class FoldedSwinBlock:
    qkv: FoldedLinear  # its k-part bias zeroed
    bias: torch.Tensor  # (heads, window^2, window^2) float32: 16 sigmoid(CPB)
    scale: torch.Tensor  # (heads,) float32: exp(min(logit_scale, ln 100))
    shift: int
    proj: FoldedLinear
    ln1: Tuple[torch.Tensor, torch.Tensor]  # post-norm of the attention
    fc1: FoldedLinear  # GELU in its epilogue
    fc2: FoldedLinear
    ln2: Tuple[torch.Tensor, torch.Tensor]  # post-norm of the MLP


@dataclass(frozen=True)
class FoldedSwinMerge:
    reduction: FoldedLinear  # 4C -> 2C, a zero shift
    norm: Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class FoldedSwin:
    """The Swin encoder folded for the kernels (:func:`fold_swin`), served
    as :class:`FoldedViT` is: :meth:`host` checks the chips a caller
    passes, and calling it on a chunk of them on the device gives the
    latents."""
    cfg: SwinConfig
    band_scale: torch.Tensor  # (in_chans,) float32
    patch: FoldedLinear  # (in_chans * patch^2 -> embed_dim)
    embed_norm: Tuple[torch.Tensor, torch.Tensor]
    stages: Tuple[Tuple[FoldedSwinBlock, ...], ...]
    merges: Tuple[FoldedSwinMerge, ...]

    def host(self, images) -> np.ndarray:
        """The encoder's input on the host: int16 digital-number chips (N,
        bands, H, W) of its config, as they are; any other dtype or shape
        is refused."""
        imgs = np.asarray(images)
        shape = self.cfg.chip_shape
        if imgs.dtype != np.int16:
            raise TypeError(f"the Swin encoder takes int16 chips (N, "
                            f"{', '.join(map(str, shape))}), got {imgs.dtype}")
        if imgs.ndim != 4 or imgs.shape[1:] != shape:
            raise ValueError(f"chips must be (N, {', '.join(map(str, shape))})"
                             f", got {imgs.shape}")
        return imgs

    def __call__(self, chunk: torch.Tensor) -> torch.Tensor:
        """int16 chips on the device -> float32 latents:
        :func:`swin_encoder_infer`."""
        return swin_encoder_infer(self, chunk)


@torch.no_grad()
def fold_swin(enc: SwinEncoder, cfg: SwinConfig,
              dtype: torch.dtype = torch.bfloat16) -> FoldedSwin:
    """The encoder's launches for activations in ``dtype``: each weight
    cast to ``dtype`` once and laid out for K1 (the patch convolution as its
    (embed_dim, in_chans * patch^2) matrix, columns in (band, row, column)
    order), biases, LayerNorm parameters, position biases and logit scales
    float32. ``cfg`` gives the band scales and the shifts."""
    dev = enc.features[0][0].weight.device
    ln = lambda m: (m.weight.detach().float().contiguous(),
                    m.bias.detach().float().contiguous())
    conv = enc.features[0][0]
    patch = FoldedLinear(
        _linear_weight(conv.weight.reshape(conv.out_channels, -1).to(dtype)),
        None, conv.bias.detach().float(), "none")
    stages, merges = [], []
    for i in range(len(cfg.depths)):
        c = cfg.widths[i]
        blocks = []
        for j, blk in enumerate(enc.features[2 * i + 1]):
            at = blk.attn
            qkv_b = at.qkv.bias.detach().float().clone()
            qkv_b[c:2 * c] = 0.0
            blocks.append(FoldedSwinBlock(
                FoldedLinear(_linear_weight(at.qkv.weight.to(dtype)), None,
                             qkv_b, "none"),
                at.position_bias().float().contiguous(),
                torch.clamp(at.logit_scale.detach().float(),
                            max=math.log(100.0)).exp().reshape(-1)
                .contiguous(),
                cfg.shift(i, j), _vit_linear(at.proj, dtype), ln(blk.norm1),
                _vit_linear(blk.mlp[0], dtype, "gelu"),
                _vit_linear(blk.mlp[3], dtype), ln(blk.norm2)))
        stages.append(tuple(blocks))
        if i + 1 < len(cfg.depths):
            m = enc.features[2 * i + 2]
            red = m.reduction.weight
            merges.append(FoldedSwinMerge(
                FoldedLinear(_linear_weight(red.to(dtype)), None,
                             torch.zeros(red.shape[0], device=dev), "none"),
                ln(m.norm)))
    return FoldedSwin(cfg, torch.tensor(cfg.band_scale, dtype=torch.float32,
                                        device=dev), patch,
                      ln(enc.features[0][2]), tuple(stages), tuple(merges))


def swin_patches(fs: FoldedSwin, x: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """int16 chips (n, in_chans, H, W) -> the patch matrix (n * side^2,
    in_chans * patch^2) in ``dtype``, each band scaled and clipped to [0,
    1] in float32: rows in (row, column) order of the patch grid, the
    columns of the convolution weight's flatten."""
    c = fs.cfg
    n, p, side = len(x), c.patch_size, c.sides[0]
    xs = x.view(n, c.in_chans, side, p, side, p) \
        .permute(0, 2, 4, 1, 3, 5).float()
    xs.mul_(fs.band_scale.view(-1, 1, 1)).clamp_(0.0, 1.0)
    out = torch.empty(xs.shape, dtype=dtype, device=x.device)
    out.copy_(xs)
    return out.view(n * side * side, -1)


def swin_encoder_infer(fs: FoldedSwin, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode Swin encoder on the kernels, as the module docstring says:
    int16 chips (n, in_chans, H, W) -> the mean of the last stage's tokens,
    (n, latent_dim) float32; the activations in the dtype ``fs`` was folded
    for. The residual stream is updated in place by the post-mode
    LayerNorms."""
    c = fs.cfg
    n, eps = len(x), c.norm_eps
    dtype = fs.patch.w.dtype
    with span("satae.swin.embed", device=True):
        patches = swin_patches(fs, x, dtype)
    _, h = layer_norm(fs.patch(patches), *fs.embed_norm, eps)
    for i, blocks in enumerate(fs.stages):
        side = c.sides[i]
        for blk in blocks:
            a = window_attention(blk.qkv(h), n, side, len(blk.scale),
                                 c.window_size, blk.shift, blk.bias,
                                 blk.scale)
            layer_norm_post(h, blk.proj(a), *blk.ln1, eps)
            layer_norm_post(h, blk.fc2(blk.fc1(h)), *blk.ln2, eps)
        if i < len(fs.merges):
            mg = fs.merges[i]
            with span("satae.swin.merge", device=True):
                m = merge_patches(h.view(n, side, side, -1)).reshape(
                    n * (side // 2) ** 2, -1).contiguous()
            _, h = layer_norm(mg.reduction(m), *mg.norm, eps)
    return torch.mean(h.view(n, -1, c.latent_dim), dim=1,
                      dtype=torch.float32)


def make_encode_classify(enc: Encoder, mlp: MLP,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 NHWC images -> predicted classes, every layer on the kernels,
    the encoder in ``compute_dtype`` and the MLP in float32. The weights are
    folded now: build again after changing them."""
    fe, fm = fold_encoder(enc, compute_dtype), fold_mlp(mlp)

    @torch.no_grad()
    def run(imgs_u8: torch.Tensor) -> torch.Tensor:
        return torch.argmax(mlp_infer(fm, fe(imgs_u8).float()), dim=-1)

    return run
