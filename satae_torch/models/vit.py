"""The ViT encoder that the pipeline serves as a frozen feature extractor:
MAE's encoder with no masking, as Prithvi-EO-1.0-100M
(ibm-nasa-geospatial/Prithvi-100M; Jakubik et al., arXiv:2310.18660) has it,
in float32 with the source's ``state_dict`` keys, so that its published
weights load as they are.

For a chip x (in_chans, num_frames, img_size, img_size), normalised per
band:

1. ``patch_embed.proj``: a Conv3d with kernel = stride = (tubelet_size,
   patch_size, patch_size) and a bias, its output flattened to tokens in
   (t, h, w) order;
2. ``pos_embed[:, 1:]`` added, a fixed 3-D sin-cos table
   (:func:`sincos_pos_embed_3d`), and the token ``cls_token +
   pos_embed[:, 0]`` prepended;
3. ``blocks.{i}``: x = x + attn.proj(MHSA(norm1(x))), then x = x +
   mlp.fc2(GELU(mlp.fc1(norm2(x)))), ``attn.qkv`` one Linear to q, k, v of
   ``num_heads`` heads (timm's layout), the exact erf GELU;
4. ``norm``: a final LayerNorm over every token.

:meth:`ViTEncoder.latent` is this pipeline's pooling: the mean of the patch
tokens (the class token left out). The serving path does not run this
module: it folds its weights once (``fast_infer.fold_vit``) and runs the
kernels (``fast_infer.vit_encoder_infer``). :func:`init_mae_` draws MAE's
init from a generator; the published weights are not in this repository.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from satae_torch.config import ViTConfig

# keys of a full MAE checkpoint that the encoder does not hold
DECODER_PREFIXES = ("decoder", "mask_token")


def sincos_pos_embed_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """MAE's 1-D table, float64 (len(pos), dim): sin then cos of pos /
    10000^(2i / dim)."""
    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64)
                            / (dim / 2.0))
    out = pos.double().reshape(-1, 1) * omega
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_pos_embed_3d(embed_dim: int, grid: Tuple[int, int, int],
                        cls_token: bool = True) -> torch.Tensor:
    """Prithvi's 3-D table (float32, (1 + t * h * w, embed_dim) with the
    class token's zero row first): per token in (t, h, w) order, its width
    position's 1-D table on 6/16 of the features, its height's on 6/16, its
    frame's on 4/16, joined in that order (w, h, t)."""
    if embed_dim % 16:
        raise ValueError("embed_dim must be a multiple of 16")
    t, h, w = grid
    dw = dh = embed_dim // 16 * 6
    dt = embed_dim // 16 * 4
    ew = sincos_pos_embed_1d(dw, torch.arange(w)).repeat(t * h, 1)
    eh = sincos_pos_embed_1d(dh, torch.arange(h)).repeat_interleave(
        w, dim=0).repeat(t, 1)
    et = sincos_pos_embed_1d(dt, torch.arange(t)).repeat_interleave(
        h * w, dim=0)
    table = torch.cat([ew, eh, et], dim=1)
    if cls_token:
        table = torch.cat([torch.zeros(1, embed_dim, dtype=table.dtype),
                           table])
    return table.float()


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        k = (cfg.tubelet_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_chans, cfg.embed_dim, k, stride=k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, -1) \
            .permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(q.shape[-1]),
                          dim=-1)
        return self.proj((a @ v).transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.embed_dim, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.mlp = Mlp(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViTEncoder(nn.Module):
    """The encoder, float32, keys as the source's ``state_dict``:
    ``patch_embed.proj``, ``cls_token``, ``pos_embed`` (fixed: not
    trained), ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
    mlp.fc2}``, ``norm``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            sincos_pos_embed_3d(d, cfg.grid)[None], requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised chips (N, in_chans, num_frames, H, W) float32 -> every
        token after the final LayerNorm, (N, 1 + num_patches, embed_dim)."""
        t = self.patch_embed(x) + self.pos_embed[:, 1:]
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(len(t), -1, -1)
        t = torch.cat([cls, t], dim=1)
        for blk in self.blocks:
            t = blk(t)
        return self.norm(t)

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        """The pipeline's latent: the mean of the patch tokens."""
        return self.forward(x)[:, 1:].mean(1)


def encoder_state_dict(sd) -> dict:
    """The encoder's entries of a ViT or full MAE ``state_dict``: the
    decoder's and the mask token's left out."""
    return {k: v for k, v in sd.items()
            if not k.startswith(DECODER_PREFIXES)}


@torch.no_grad()
def init_mae_(enc: ViTEncoder,
              generator: Optional[torch.Generator] = None) -> ViTEncoder:
    """MAE's init (``initialize_weights``) drawn from ``generator``: the
    patch projection xavier-uniform on its (embed_dim, -1) view, its bias
    PyTorch's Conv3d default, the class token N(0, 0.02), every Linear
    xavier-uniform with a zero bias, every LayerNorm 1 and 0, the sin-cos
    table fixed."""
    g = generator

    def xavier(w2d: torch.Tensor) -> None:
        a = math.sqrt(6.0 / (w2d.shape[0] + w2d.shape[1]))
        w2d.uniform_(-a, a, generator=g)

    w = enc.patch_embed.proj.weight
    xavier(w.view(w.shape[0], -1))
    fan = w[0].numel()
    enc.patch_embed.proj.bias.uniform_(-1 / math.sqrt(fan),
                                       1 / math.sqrt(fan), generator=g)
    enc.cls_token.normal_(0.0, 0.02, generator=g)
    enc.pos_embed.copy_(sincos_pos_embed_3d(enc.cfg.embed_dim,
                                            enc.cfg.grid)[None])
    for m in enc.modules():
        if isinstance(m, nn.Linear):
            xavier(m.weight)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return enc
