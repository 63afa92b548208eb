"""A plain float32 reference of Prithvi-EO-1.0-100M's encoder (MAE's ViT
encoder with no masking; ibm-nasa-geospatial/Prithvi-100M, arXiv:2310.18660)
with this pipeline's pooling and MLP head, written from the layer
equations for the tests of the port. It imports nothing of satae_torch,
satae or JAX; on a card it runs with TF32 and cuDNN off (:class:`no_tf32`).

Parameters are a dict under the source's ``state_dict`` keys
(``patch_embed.proj.weight`` (d, bands, tubelet, p, p), ``cls_token``,
``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}.{weight,bias}``, ``norm.{weight,bias}``), the head's under the
pipeline MLP's (``net.{0,1,4,5,7}``: Linear, BatchNorm1d, ReLU, Dropout,
Linear, BatchNorm1d, ReLU, Linear). ``cfg`` is a dict of the widths:
img_size, patch_size, num_frames, tubelet_size, in_chans, embed_dim, depth,
num_heads, mlp_ratio, norm_eps.

For a chip x (bands, frames, H, W) of int16 reflectance:
  x' = (x - mean_b) / std_b per band;
  tokens = patches(x') @ W_patch^T + b_patch + pos[1:], (t, h, w) order,
  with cls_token + pos[0] first;
  per block x = x + proj(MHSA(LN1(x))), x = x + fc2(GELU(fc1(LN2(x))));
  LN(x); the latent is the mean of the patch tokens; the head's logits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Params = Dict[str, torch.Tensor]


class no_tf32:
    """float32 arithmetic on the card within the block: both TF32 switches
    and cuDNN off, restored on exit."""

    def __enter__(self):
        cudnn = torch.backends.cudnn
        self.saved = (torch.backends.cuda.matmul.allow_tf32, cudnn.enabled,
                      cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        cudnn.enabled, cudnn.allow_tf32 = False, False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.enabled,
         torch.backends.cudnn.allow_tf32) = self.saved


def grid(cfg: dict) -> Tuple[int, int, int]:
    side = cfg["img_size"] // cfg["patch_size"]
    return cfg["num_frames"] // cfg["tubelet_size"], side, side


def _sincos(dim: int, n: int) -> torch.Tensor:
    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64)
                            / (dim / 2.0))
    arg = torch.arange(n, dtype=torch.float64)[:, None] * omega[None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)


def pos_table(cfg: dict) -> torch.Tensor:
    """(1 + t h w, d) float32: a zero row, then per token (t, h, w) the
    concatenation of its column's, row's and frame's sin-cos tables on 6,
    6 and 4 sixteenths of the features."""
    d = cfg["embed_dim"]
    t, h, w = grid(cfg)
    rows = []
    for ti in range(t):
        for hi in range(h):
            for wi in range(w):
                rows.append(torch.cat([_sincos(d // 16 * 6, w)[wi],
                                       _sincos(d // 16 * 6, h)[hi],
                                       _sincos(d // 16 * 4, t)[ti]]))
    return torch.cat([torch.zeros(1, d, dtype=torch.float64),
                      torch.stack(rows)]).float()


def shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    d, k = cfg["embed_dim"], int(cfg["embed_dim"] * cfg["mlp_ratio"])
    p, tb, c = cfg["patch_size"], cfg["tubelet_size"], cfg["in_chans"]
    t, h, w = grid(cfg)
    out = [("cls_token", (1, 1, d)), ("pos_embed", (1, 1 + t * h * w, d)),
           ("patch_embed.proj.weight", (d, c, tb, p, p)),
           ("patch_embed.proj.bias", (d,))]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,)), (b + "norm1.bias", (d,)),
                (b + "attn.qkv.weight", (3 * d, d)),
                (b + "attn.qkv.bias", (3 * d,)),
                (b + "attn.proj.weight", (d, d)),
                (b + "attn.proj.bias", (d,)),
                (b + "norm2.weight", (d,)), (b + "norm2.bias", (d,)),
                (b + "mlp.fc1.weight", (k, d)), (b + "mlp.fc1.bias", (k,)),
                (b + "mlp.fc2.weight", (d, k)), (b + "mlp.fc2.bias", (d,))]
    return out + [("norm.weight", (d,)), ("norm.bias", (d,))]


def init_params(cfg: dict, seed: int, spread: float = 0.02) -> Params:
    """MAE's init from ``seed`` (xavier-uniform weights, the patch
    projection on its (d, -1) view; N(0, 0.02) class token; the fixed
    table), then every bias and LayerNorm parameter moved off its init
    value by N(0, spread), so that each one is checked."""
    g = torch.Generator().manual_seed(seed)
    out: Params = {}
    for name, shape in shapes(cfg):
        if name == "pos_embed":
            out[name] = pos_table(cfg)[None]
        elif name == "cls_token":
            out[name] = torch.randn(shape, generator=g) * 0.02
        elif name.endswith("weight") and len(shape) >= 2:
            fan_out, fan_in = shape[0], math.prod(shape[1:])
            a = math.sqrt(6.0 / (fan_in + fan_out))
            out[name] = (torch.rand(shape, generator=g) * 2 - 1) * a
        else:
            base = 1.0 if name.endswith("norm1.weight") or \
                name.endswith("norm2.weight") or name == "norm.weight" \
                else 0.0
            out[name] = base + torch.randn(shape, generator=g) * spread
    return out


def head_init(dims: List[int], seed: int) -> Params:
    """The MLP head's tensors for widths ``dims`` (latent, hidden..., classes):
    PyTorch's default Linear bounds, BatchNorm scales in [0.5, 1.5), shifts in
    [-0.2, 0.2), running means N(0, 0.1) and variances in [0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    out: Params = {}
    idx = 0
    for i in range(len(dims) - 1):
        a, b = dims[i], dims[i + 1]
        bound = 1.0 / math.sqrt(a)
        out[f"net.{idx}.weight"] = (torch.rand(b, a, generator=g) * 2 - 1) \
            * bound
        out[f"net.{idx}.bias"] = (torch.rand(b, generator=g) * 2 - 1) * bound
        if i == len(dims) - 2:
            break
        bn = f"net.{idx + 1}."
        out[bn + "weight"] = torch.rand(b, generator=g) + 0.5
        out[bn + "bias"] = (torch.rand(b, generator=g) - 0.5) * 0.4
        out[bn + "running_mean"] = torch.randn(b, generator=g) * 0.1
        out[bn + "running_var"] = torch.rand(b, generator=g) + 0.5
        out[bn + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        idx += 4 if i == 0 else 3
    return out


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def tokens(p: Params, cfg: dict, chips: torch.Tensor, mean, std
           ) -> torch.Tensor:
    """int16 chips (n, bands, frames, H, W) -> every token after the final
    LayerNorm, (n, 1 + patches, d), float32."""
    n = len(chips)
    c, tb, ps = cfg["in_chans"], cfg["tubelet_size"], cfg["patch_size"]
    d, heads, eps = cfg["embed_dim"], cfg["num_heads"], cfg["norm_eps"]
    t, h, w = grid(cfg)
    dev = chips.device
    m = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    s = torch.as_tensor(std, dtype=torch.float32, device=dev)
    x = (chips.float() - m.view(1, c, 1, 1, 1)) / s.view(1, c, 1, 1, 1)
    # patch (t, h, w) of chip i: x[i, :, t*tb:(t+1)*tb, h*ps:.., w*ps:..]
    # flattened as the Conv3d weight is, (band, frame, row, column)
    x = x.reshape(n, c, t, tb, h, ps, w, ps).permute(0, 2, 4, 6, 1, 3, 5, 7)
    x = x.reshape(n, t * h * w, c * tb * ps * ps)
    pw = p["patch_embed.proj.weight"].reshape(d, -1)
    x = x @ pw.t() + p["patch_embed.proj.bias"] + p["pos_embed"][0, 1:]
    cls = (p["cls_token"][0, 0] + p["pos_embed"][0, 0]).expand(n, 1, d)
    x = torch.cat([cls, x], dim=1)
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        y = _layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"], eps)
        qkv = y @ p[b + "attn.qkv.weight"].t() + p[b + "attn.qkv.bias"]
        q, k, v = qkv.reshape(n, -1, 3, heads, d // heads) \
            .permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads),
                          dim=-1) @ v
        a = a.transpose(1, 2).reshape(n, -1, d)
        x = x + a @ p[b + "attn.proj.weight"].t() + p[b + "attn.proj.bias"]
        y = _layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"], eps)
        y = _gelu(y @ p[b + "mlp.fc1.weight"].t() + p[b + "mlp.fc1.bias"])
        x = x + y @ p[b + "mlp.fc2.weight"].t() + p[b + "mlp.fc2.bias"]
    return _layer_norm(x, p["norm.weight"], p["norm.bias"], eps)


def latents(p: Params, cfg: dict, chips: torch.Tensor, mean, std
            ) -> torch.Tensor:
    """The pipeline's latent: the mean of the patch tokens, (n, d)."""
    return tokens(p, cfg, chips, mean, std)[:, 1:].mean(1)


def head_logits(hp: Params, z: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    """The MLP head in eval mode: dropout the identity, BatchNorm on its
    running statistics."""
    idx, x = 0, z
    while f"net.{idx}.weight" in hp:
        x = x @ hp[f"net.{idx}.weight"].t() + hp[f"net.{idx}.bias"]
        bn = f"net.{idx + 1}."
        if bn + "running_mean" not in hp:
            return x
        x = (x - hp[bn + "running_mean"]) / torch.sqrt(
            hp[bn + "running_var"] + eps) * hp[bn + "weight"] + hp[bn + "bias"]
        x = torch.relu(x)
        idx += 4 if idx == 0 else 3
    return x
