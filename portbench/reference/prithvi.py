"""The plain reference of Prithvi-EO-1.0-100M's encoder (MAE's ViT encoder
with no masking; huggingface.co/ibm-nasa-geospatial/Prithvi-EO-1.0-100M,
arXiv:2310.18660) with the pipeline's pooling and MLP head, in float32
PyTorch with TF32 and cuDNN off, written from the layer equations.

It imports nothing of the program under test, nor JAX: its parameters are
a dict under the source's ``state_dict`` keys (``patch_embed.proj.weight``
(d, bands, tubelet, p, p), ``cls_token``, ``pos_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
``norm``), which the program loads as they are; the head is the latent
MLP of portbench.reference.model, under its keys. ``m`` is the
configuration's ``model`` dict (img_size, patch_size, num_frames,
tubelet_size, in_chans, embed_dim, depth, num_heads, mlp_ratio, norm_eps).

For a chip x (bands, frames, H, W) of int16 reflectance:
  x' = (x - mean_b) / std_b per band;
  tokens = patches(x') @ W_patch^T + b_patch + pos[1:], in (t, h, w) order,
  with cls_token + pos[0] first;
  per block x = x + proj(MHSA(LN1(x))), then x = x + fc2(GELU(fc1(LN2(x)))),
  softmax(q k^T / sqrt(64)) v over every token, GELU the exact erf form;
  LN(x); the latent is the mean of the patch tokens.

Every product (the linears and attention's two) goes through
``reference.model.mm_op``'s rounding ``q`` of both operands: the identity
for the reference, a lower precision for the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import model as R

Params = Dict[str, torch.Tensor]


def grid(m: dict) -> Tuple[int, int, int]:
    side = m["img_size"] // m["patch_size"]
    return m["num_frames"] // m["tubelet_size"], side, side


def mlp_dim(m: dict) -> int:
    return int(m["embed_dim"] * m["mlp_ratio"])


def _sincos(dim: int, n: int) -> torch.Tensor:
    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64)
                            / (dim / 2.0))
    arg = torch.arange(n, dtype=torch.float64)[:, None] * omega[None]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)


def pos_table(m: dict) -> torch.Tensor:
    """(1 + t h w, d) float32 on the host: a zero row (the class token's),
    then per token (t, h, w) its column's, row's and frame's 1-D sin-cos
    tables on 6, 6 and 4 sixteenths of the features, joined in that
    order."""
    d = m["embed_dim"]
    t, h, w = grid(m)
    ew, eh, et = (_sincos(d // 16 * 6, w), _sincos(d // 16 * 6, h),
                  _sincos(d // 16 * 4, t))
    rows = [torch.cat([ew[wi], eh[hi], et[ti]])
            for ti in range(t) for hi in range(h) for wi in range(w)]
    return torch.cat([torch.zeros(1, d, dtype=torch.float64),
                      torch.stack(rows)]).float()


def shapes(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every encoder tensor, in ``state_dict`` order."""
    d, k = m["embed_dim"], mlp_dim(m)
    p, tb, c = m["patch_size"], m["tubelet_size"], m["in_chans"]
    t, h, w = grid(m)
    out = [("cls_token", (1, 1, d)), ("pos_embed", (1, 1 + t * h * w, d)),
           ("patch_embed.proj.weight", (d, c, tb, p, p)),
           ("patch_embed.proj.bias", (d,))]
    for i in range(m["depth"]):
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


@torch.no_grad()
def init_params(m: dict, gen: torch.Generator, device,
                spread: float = 0.02) -> Params:
    """MAE's init from ``gen`` on ``device``: xavier-uniform weights (the
    patch projection on its (d, -1) view), the class token N(0, 0.02), the
    fixed table; then every bias and LayerNorm parameter moved off its init
    value (0, or 1 for a LayerNorm's scale) by N(0, ``spread``), so that
    the check sees each of them."""
    out: Params = {}
    for name, shape in shapes(m):
        if name == "pos_embed":
            out[name] = pos_table(m)[None].to(device)
        elif name == "cls_token":
            out[name] = torch.randn(shape, generator=gen, device=device) \
                * 0.02
        elif len(shape) >= 2:
            a = math.sqrt(6.0 / (shape[0] + math.prod(shape[1:])))
            out[name] = (torch.rand(shape, generator=gen, device=device)
                         * 2 - 1) * a
        else:
            base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
            out[name] = base + torch.randn(shape, generator=gen,
                                           device=device) * spread
    return out


def _layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _bmm(a, b):
    return a @ b


def latents(p: Params, m: dict, chips: torch.Tensor, mean, std,
            q: R.Round = R.identity) -> torch.Tensor:
    """int16 chips (n, bands, frames, H, W) -> the latents (n, d) float32,
    on the chips' device; call within ``R.no_tf32()``."""
    n = len(chips)
    c, tb, ps = m["in_chans"], m["tubelet_size"], m["patch_size"]
    d, heads, eps = m["embed_dim"], m["num_heads"], m["norm_eps"]
    t, h, w = grid(m)
    dev = chips.device
    mu = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    sd = torch.as_tensor(std, dtype=torch.float32, device=dev)
    x = (chips.float() - mu.view(1, c, 1, 1, 1)) / sd.view(1, c, 1, 1, 1)
    x = x.reshape(n, c, t, tb, h, ps, w, ps).permute(0, 2, 4, 6, 1, 3, 5, 7)
    x = x.reshape(n * t * h * w, c * tb * ps * ps)
    x = R.mm_op(R._linear, x, p["patch_embed.proj.weight"].reshape(d, -1),
                p["patch_embed.proj.bias"], q)
    x = x.view(n, t * h * w, d) + p["pos_embed"][0, 1:]
    cls = (p["cls_token"][0, 0] + p["pos_embed"][0, 0]).expand(n, 1, d)
    x = torch.cat([cls, x], dim=1)
    rows = x.shape[1]

    def linear(y, name):
        return R.mm_op(R._linear, y.reshape(-1, y.shape[-1]),
                       p[name + ".weight"], p[name + ".bias"], q) \
            .view(n, rows, -1)

    zero = torch.zeros((), device=dev)
    for i in range(m["depth"]):
        b = f"blocks.{i}."
        y = _layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"], eps)
        qh, kh, vh = linear(y, b + "attn.qkv").view(
            n, rows, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        s = R.mm_op(_bmm, qh, kh.transpose(-1, -2), zero, q) \
            / math.sqrt(d // heads)
        a = R.mm_op(_bmm, torch.softmax(s, dim=-1), vh, zero, q)
        x = x + linear(a.transpose(1, 2).reshape(n, rows, d),
                       b + "attn.proj")
        y = _layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"], eps)
        x = x + linear(_gelu(linear(y, b + "mlp.fc1")), b + "mlp.fc2")
    x = _layer_norm(x, p["norm.weight"], p["norm.bias"], eps)
    return x[:, 1:].mean(1)


def serve_logits(enc: Params, head: Params, chips: torch.Tensor, m: dict,
                 mh: dict, mean, std, q: R.Round = R.identity,
                 block: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(latents (N, d), the head's logits (N, classes)), float32, computed
    in blocks of ``block`` chips on the chips' device."""
    with R.no_tf32():
        zs, outs = [], []
        for lo in range(0, len(chips), block):
            z = latents(enc, m, chips[lo:lo + block], mean, std, q)
            zs.append(z)
            outs.append(R.mlp(head, z, mh, q=q))
        return torch.cat(zs), torch.cat(outs)
