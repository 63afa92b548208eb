"""The Swin Transformer V2 encoder that the pipeline serves as a frozen
feature extractor: torchvision's ``swin_v2_b`` features (Liu et al.,
arXiv:2111.09883) as SatlasPretrain ships them for Sentinel-2 (Bastani et
al., arXiv:2211.15660; ``Sentinel2_SwinB_SI_MS``: the first convolution
taking 9 bands), in float32 with torchvision's ``state_dict`` keys, so that
a published checkpoint loads as it is.

For a chip x (in_chans, H, W), each band scaled and clipped to [0, 1]:

1. ``features.0``: ``Conv2d(in_chans, embed_dim, patch, stride patch)``,
   channels last, ``LayerNorm``;
2. ``features.{1,3,5,7}.{i}``, the blocks of the four stages, res-post-norm:
   x = x + norm1(attn(x)), then x = x + norm2(mlp.3(GELU(mlp.0(x))));
   ``attn`` is shifted-window cosine attention: the tokens rolled by (-s,
   -s) (s = 0 in even blocks, half the window in odd ones, 0 where the side
   is the window), cut into window x window windows, per head
   cos(q_i, k_j) * exp(min(logit_scale, ln 100)) + 16 * sigmoid(
   cpb_mlp(relative_coords_table))[relative_position_index], -100 between
   tokens of different regions of a shifted window, softmax, the heads
   joined, ``proj``, the windows put back and the roll undone; ``qkv``'s
   k-part bias is zeroed at every call;
3. ``features.{2,4,6}``, patch merging: the 2 x 2 neighbours joined as
   (x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]),
   ``reduction`` (no bias), ``norm``.

:meth:`SwinEncoder.latent` is the pipeline's pooling: the mean of the last
stage's tokens, without torchvision's final ``norm`` (Satlas's backbone
returns the stages' features). The serving path does not run this module:
it folds its weights once (``fast_infer.fold_swin``) and runs the kernels
(``fast_infer.swin_encoder_infer``). The published weights are not in this
repository.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from satae_torch.config import SwinConfig
from satae_torch.kernels.window_attention import region_labels

# the prefixes a checkpoint may wrap the backbone's keys in: Satlas's
# ``backbone.backbone.`` (its Swin inside its backbone wrapper)
WRAPPER_PREFIXES = ("backbone.backbone.", "backbone.")


def relative_coords_table(window: int) -> torch.Tensor:
    """torchvision's (1, 2w - 1, 2w - 1, 2) table of the log-spaced
    relative offsets: t / (w - 1) * 8, then sign(t) log2(1 + |t|) / 3."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    t = torch.stack(torch.meshgrid([r, r], indexing="ij")).permute(1, 2, 0)
    t = t.contiguous().unsqueeze(0) / (window - 1) * 8
    return torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / 3.0


def relative_position_index(window: int) -> torch.Tensor:
    """torchvision's (w^4,) index of each token pair (i, j) of a window, in
    row-major token order, into the (2w - 1)^2 offsets."""
    c = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                   indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).flatten()


class Permute(nn.Module):
    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class WindowAttentionV2(nn.Module):
    """torchvision's ``ShiftedWindowAttentionV2`` under its keys."""

    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones(heads, 1,
                                                                  1)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(inplace=True),
                                     nn.Linear(512, heads, bias=False))
        self.register_buffer("relative_coords_table",
                             relative_coords_table(window))
        self.register_buffer("relative_position_index",
                             relative_position_index(window))

    def position_bias(self) -> torch.Tensor:
        """(heads, w^2, w^2): 16 sigmoid(cpb_mlp(table)) at each pair's
        offset."""
        n = self.window ** 2
        t = self.cpb_mlp(self.relative_coords_table).view(-1, self.heads)
        b = t[self.relative_position_index].view(n, n, -1).permute(2, 0, 1)
        return 16 * torch.sigmoid(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, C)."""
        b, h, w, c = x.shape
        ws, s = self.window, self.shift
        if ws >= h:
            s = 0
        if s:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        nh, nw = h // ws, w // ws
        x = x.view(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b * nh * nw, ws * ws, c)
        bias = self.qkv.bias.clone()
        bias[c:2 * c].zero_()
        qkv = F.linear(x, self.qkv.weight, bias)
        q, k, v = qkv.reshape(len(x), ws * ws, 3, self.heads, -1) \
            .permute(2, 0, 3, 1, 4)
        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1) \
            .transpose(-2, -1)
        attn = attn * torch.clamp(self.logit_scale,
                                  max=math.log(100.0)).exp()
        attn = attn + self.position_bias()[None]
        if s:
            lab = region_labels(h, ws, s, x.device).view(nh, ws, nw, ws) \
                .permute(0, 2, 1, 3).reshape(nh * nw, ws * ws)
            mask = (lab[:, None, :] != lab[:, :, None]).float() * -100.0
            attn = attn.view(b, nh * nw, self.heads, ws * ws, ws * ws) \
                + mask[None, :, None]
            attn = attn.view(-1, self.heads, ws * ws, ws * ws)
        x = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2) \
            .reshape(len(x), ws * ws, c)
        x = self.proj(x)
        x = x.view(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, h, w, c)
        if s:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        return x


class BlockV2(nn.Module):
    """torchvision's ``SwinTransformerBlockV2``: res-post-norm."""

    def __init__(self, dim: int, heads: int, cfg: SwinConfig, shift: int):
        super().__init__()
        hidden = int(dim * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.attn = WindowAttentionV2(dim, heads, cfg.window_size, shift)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.norm1(self.attn(x))
        return x + self.norm2(self.mlp(x))


def merge_patches(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/2, W/2, 4C): each 2 x 2 neighbourhood
    joined in torchvision's order x[0::2, 0::2], x[1::2, 0::2], x[0::2,
    1::2], x[1::2, 1::2] (H and W even)."""
    *lead, h, w, c = x.shape
    y = x.reshape(*lead, h // 2, 2, w // 2, 2, c)
    nd = len(lead)
    # (..., i, dy, j, dx, c) -> (..., i, j, dx, dy, c): x0..x3 = dx * 2 + dy
    y = y.permute(*range(nd), nd, nd + 2, nd + 3, nd + 1, nd + 4)
    return y.reshape(*lead, h // 2, w // 2, 4 * c)


class PatchMergingV2(nn.Module):
    def __init__(self, dim: int, cfg: SwinConfig):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=cfg.norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.reduction(merge_patches(x)))


class SwinEncoder(nn.Module):
    """The encoder, float32, keys as torchvision's ``swin_v2_b``
    ``features``: ``features.0.{0,2}`` (the patch convolution and its
    LayerNorm), ``features.{1,3,5,7}.{i}.{norm1, attn.{qkv, proj,
    logit_scale, cpb_mlp.{0,2}, relative_coords_table,
    relative_position_index}, norm2, mlp.{0,3}}``,
    ``features.{2,4,6}.{reduction, norm}``."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        layers = [nn.Sequential(
            nn.Conv2d(cfg.in_chans, cfg.embed_dim, (p, p), stride=(p, p)),
            Permute(0, 2, 3, 1),
            nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps))]
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            dim = cfg.widths[i]
            layers.append(nn.Sequential(*(
                BlockV2(dim, heads, cfg, cfg.shift(i, j))
                for j in range(depth))))
            if i + 1 < len(cfg.depths):
                layers.append(PatchMergingV2(dim, cfg))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Scaled chips (N, in_chans, H, W) float32 -> the last stage's
        tokens (N, side, side, latent_dim)."""
        return self.features(x)

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        """The pipeline's latent: the mean of the last stage's tokens."""
        return self.forward(x).mean((1, 2))


def swin_state_dict(sd) -> Dict[str, torch.Tensor]:
    """The encoder's entries of a checkpoint: a wrapper's prefix
    (:data:`WRAPPER_PREFIXES`) stripped, and only the ``features.`` keys
    kept (torchvision's final ``norm`` and ``head``, and a wrapper's other
    heads, left out)."""
    out = {}
    for k, v in sd.items():
        for pre in WRAPPER_PREFIXES:
            if k.startswith(pre + "features."):
                k = k[len(pre):]
                break
        if k.startswith("features."):
            out[k] = v
    return out
