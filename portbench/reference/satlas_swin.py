"""The plain reference of SatlasPretrain's Sentinel-2 Swin-v2-B backbone
(``Sentinel2_SwinB_SI_MS``, github.com/allenai/satlaspretrain_models:
torchvision's ``swin_v2_b`` features with a 9-band first convolution;
Bastani et al., arXiv:2211.15660; Swin V2, Liu et al., arXiv:2111.09883)
with the pipeline's pooling and MLP head, in float32 PyTorch with TF32 and
cuDNN off, written from the layer equations.

It imports nothing of the program under test, nor JAX: its parameters are
a dict under torchvision's ``state_dict`` keys (``features.0.0`` the patch
convolution, ``features.0.2`` its LayerNorm, ``features.{1,3,5,7}.{j}``
the blocks, ``features.{2,4,6}`` the merges), which the program loads as
they are; the position biases are computed here from ``cpb_mlp`` on the
table, not folded. The head is the latent MLP of portbench.reference.model,
under its keys. ``m`` is the configuration's ``model`` dict (img_size,
patch_size, in_chans, embed_dim, depths, num_heads, window_size,
mlp_ratio, norm_eps, band_scale).

For a chip x (bands, H, W) of int16 digital numbers:
  x' = clip(x * scale_b, 0, 1) per band;
  tokens = LN(patches(x') @ W^T + b), (row, column) order, channels last;
  per block (shift s = 0 in even blocks, window / 2 in odd ones, 0 where
  the side is the window):
    x = x + LN1(attn(x)), x = x + LN2(fc2(GELU(fc1(x))));
    attn: roll by (-s, -s), 8 x 8 windows; q, k, v = x W_qkv^T + b_qkv with
    b_qkv's k part zero; per head S = (q / |q|)(k / |k|)^T exp(min(tau,
    ln 100)) + 16 sigmoid(cpb(T))[rel(i, j)] - 100 [regions differ];
    softmax(S) v, heads joined, proj, windows put back, roll by (s, s);
  between stages: cat(x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
  x[1::2, 1::2]) W_red^T, LN;
  the latent is the mean of the last stage's tokens (no final LN).

Every product (the linears, the CPB MLP, and attention's two) goes through
``reference.model.mm_op``'s rounding ``q`` of both operands: the identity
for the reference, a lower precision for the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import model as R

Params = Dict[str, torch.Tensor]
CPB_HIDDEN = 512


def widths(m: dict) -> List[int]:
    return [m["embed_dim"] * 2 ** i for i in range(len(m["depths"]))]


def sides(m: dict) -> List[int]:
    s = m["img_size"] // m["patch_size"]
    return [s // 2 ** i for i in range(len(m["depths"]))]


def coords_table(w: int) -> torch.Tensor:
    """(1, 2w - 1, 2w - 1, 2): each offset (dy, dx) as sign(t) log2(1 +
    |t|) / 3 with t = 8 d / (w - 1)."""
    r = torch.arange(-(w - 1), w, dtype=torch.float32) / (w - 1) * 8
    t = torch.stack([r[:, None].expand(2 * w - 1, 2 * w - 1),
                     r[None, :].expand(2 * w - 1, 2 * w - 1)], dim=-1)
    return (torch.sign(t) * torch.log2(1 + t.abs()) / 3)[None]


def position_index(w: int) -> torch.Tensor:
    """(w^4,) int64: for tokens i = (yi, xi), j = (yj, xj) of a window in
    row-major order, (yi - yj + w - 1) (2w - 1) + (xi - xj + w - 1)."""
    y = torch.arange(w * w) // w
    x = torch.arange(w * w) % w
    dy = y[:, None] - y[None, :] + w - 1
    dx = x[:, None] - x[None, :] + w - 1
    return (dy * (2 * w - 1) + dx).reshape(-1)


def shapes(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every encoder tensor, buffers included, in
    ``state_dict`` order."""
    e, c, p = m["embed_dim"], m["in_chans"], m["patch_size"]
    w = m["window_size"]
    out = [("features.0.0.weight", (e, c, p, p)), ("features.0.0.bias", (e,)),
           ("features.0.2.weight", (e,)), ("features.0.2.bias", (e,))]
    for i, (depth, heads) in enumerate(zip(m["depths"], m["num_heads"])):
        d = widths(m)[i]
        k = int(d * m["mlp_ratio"])
        for j in range(depth):
            b = f"features.{2 * i + 1}.{j}."
            out += [(b + "norm1.weight", (d,)), (b + "norm1.bias", (d,)),
                    (b + "attn.logit_scale", (heads, 1, 1)),
                    (b + "attn.relative_coords_table",
                     (1, 2 * w - 1, 2 * w - 1, 2)),
                    (b + "attn.relative_position_index", (w ** 4,)),
                    (b + "attn.qkv.weight", (3 * d, d)),
                    (b + "attn.qkv.bias", (3 * d,)),
                    (b + "attn.proj.weight", (d, d)),
                    (b + "attn.proj.bias", (d,)),
                    (b + "attn.cpb_mlp.0.weight", (CPB_HIDDEN, 2)),
                    (b + "attn.cpb_mlp.0.bias", (CPB_HIDDEN,)),
                    (b + "attn.cpb_mlp.2.weight", (heads, CPB_HIDDEN)),
                    (b + "norm2.weight", (d,)), (b + "norm2.bias", (d,)),
                    (b + "mlp.0.weight", (k, d)), (b + "mlp.0.bias", (k,)),
                    (b + "mlp.3.weight", (d, k)), (b + "mlp.3.bias", (d,))]
        if i + 1 < len(m["depths"]):
            b = f"features.{2 * i + 2}."
            out += [(b + "reduction.weight", (2 * d, 4 * d)),
                    (b + "norm.weight", (2 * d,)), (b + "norm.bias", (2 * d,))]
    return out


@torch.no_grad()
def init_params(m: dict, gen: torch.Generator, device,
                spread: float = 0.02) -> Params:
    """The init from ``gen`` on ``device``: every Linear weight
    xavier-uniform (MAE's, as the ViT cell draws it: torchvision's
    truncated-normal std 0.02 leaves each block's branch dominated by its
    biases, and the latent 0.4 % chip-dependent, under bf16's rounding), the
    patch convolution uniform in +-1/sqrt(fan_in) (weight and bias: PyTorch's
    default), LayerNorm 1 and 0, the fixed buffers; then every bias and
    LayerNorm parameter moved off its init value by N(0, ``spread``), and
    each head's ``logit_scale`` drawn uniform in [ln 10, ln 100 + 0.5), so
    that some heads sit at the clamp and the check sees each parameter."""
    out: Params = {}
    w = m["window_size"]
    fan = m["in_chans"] * m["patch_size"] ** 2
    for name, shape in shapes(m):
        if name.endswith("relative_coords_table"):
            out[name] = coords_table(w).to(device)
        elif name.endswith("relative_position_index"):
            out[name] = position_index(w).to(device)
        elif name.endswith("logit_scale"):
            out[name] = torch.rand(shape, generator=gen, device=device) \
                * (math.log(100.0) + 0.5 - math.log(10.0)) + math.log(10.0)
        elif name.startswith("features.0.0."):
            out[name] = (torch.rand(shape, generator=gen, device=device)
                         * 2 - 1) / math.sqrt(fan)
        elif len(shape) >= 2:
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (torch.rand(shape, generator=gen, device=device)
                         * 2 - 1) * a
        else:
            base = 1.0 if ("norm" in name and name.endswith("weight")) \
                else 0.0
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


def _regions(side: int, w: int, s: int, device) -> torch.Tensor:
    """(side, side) the region of each token of the rolled grid: per axis 0
    below side - w, 1 below side - s, 2 above; 3 * row's + column's."""
    ax = torch.arange(side, device=device)
    r = (ax >= side - w).long() + (ax >= side - s).long()
    return r[:, None] * 3 + r[None, :]


def _attention(p: Params, pre: str, x: torch.Tensor, heads: int, shift: int,
               m: dict, q: R.Round) -> torch.Tensor:
    """x (n, side, side, d) -> the block's attention branch, same shape."""
    n, side, _, d = x.shape
    w, hd = m["window_size"], d // heads
    nw = side // w
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    win = x.reshape(n, nw, w, nw, w, d).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n * nw * nw, w * w, d)
    bias = p[pre + "qkv.bias"].clone()
    bias[d:2 * d] = 0.0
    qkv = R.mm_op(R._linear, win.reshape(-1, d), p[pre + "qkv.weight"], bias,
                  q).view(len(win), w * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qn = qkv[0] / qkv[0].norm(dim=-1, keepdim=True).clamp_min(1e-12)
    kn = qkv[1] / qkv[1].norm(dim=-1, keepdim=True).clamp_min(1e-12)
    zero = torch.zeros((), device=x.device)
    s = R.mm_op(_bmm, qn, kn.transpose(-1, -2), zero, q)
    tau = p[pre + "logit_scale"].reshape(1, heads, 1, 1)
    s = s * torch.exp(torch.clamp(tau, max=math.log(100.0)))
    hid = torch.relu(R.mm_op(R._linear,
                             p[pre + "relative_coords_table"].reshape(-1, 2),
                             p[pre + "cpb_mlp.0.weight"],
                             p[pre + "cpb_mlp.0.bias"], q))
    table = R.mm_op(R._linear, hid, p[pre + "cpb_mlp.2.weight"], zero, q)
    rel = table[p[pre + "relative_position_index"]].view(w * w, w * w, heads)
    s = s + 16 * torch.sigmoid(rel.permute(2, 0, 1))[None]
    if shift:
        lab = _regions(side, w, shift, x.device).reshape(nw, w, nw, w) \
            .permute(0, 2, 1, 3).reshape(nw * nw, w * w)
        cross = (lab[:, :, None] != lab[:, None, :]).float() * -100.0
        s = (s.view(n, nw * nw, heads, w * w, w * w)
             + cross[None, :, None]).view_as(s)
    o = R.mm_op(_bmm, torch.softmax(s, dim=-1), qkv[2], zero, q)
    o = o.transpose(1, 2).reshape(-1, d)
    o = R.mm_op(R._linear, o, p[pre + "proj.weight"], p[pre + "proj.bias"], q)
    o = o.view(n, nw, nw, w, w, d).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, side, side, d)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return o


def latents(p: Params, m: dict, chips: torch.Tensor,
            q: R.Round = R.identity) -> torch.Tensor:
    """int16 chips (n, bands, H, W) -> the latents (n, 8 * embed_dim)
    float32, on the chips' device; call within ``R.no_tf32()``."""
    n = len(chips)
    c, ps, e, eps = (m["in_chans"], m["patch_size"], m["embed_dim"],
                     m["norm_eps"])
    side = sides(m)[0]
    scale = torch.as_tensor(m["band_scale"], dtype=torch.float32,
                            device=chips.device)
    x = (chips.float() * scale.view(1, c, 1, 1)).clamp(0.0, 1.0)
    x = x.reshape(n, c, side, ps, side, ps).permute(0, 2, 4, 1, 3, 5) \
        .reshape(n * side * side, c * ps * ps)
    x = R.mm_op(R._linear, x, p["features.0.0.weight"].reshape(e, -1),
                p["features.0.0.bias"], q)
    x = _layer_norm(x, p["features.0.2.weight"], p["features.0.2.bias"],
                    eps).view(n, side, side, e)
    w = m["window_size"]
    for i, (depth, heads) in enumerate(zip(m["depths"], m["num_heads"])):
        s_i = sides(m)[i]
        d = widths(m)[i]
        for j in range(depth):
            pre = f"features.{2 * i + 1}.{j}."
            shift = w // 2 if j % 2 and s_i > w else 0
            a = _attention(p, pre + "attn.", x, heads, shift, m, q)
            x = x + _layer_norm(a, p[pre + "norm1.weight"],
                                p[pre + "norm1.bias"], eps)
            h = _gelu(R.mm_op(R._linear, x.reshape(-1, d),
                              p[pre + "mlp.0.weight"], p[pre + "mlp.0.bias"],
                              q))
            h = R.mm_op(R._linear, h, p[pre + "mlp.3.weight"],
                        p[pre + "mlp.3.bias"], q).view_as(x)
            x = x + _layer_norm(h, p[pre + "norm2.weight"],
                                p[pre + "norm2.bias"], eps)
        if i + 1 < len(m["depths"]):
            pre = f"features.{2 * i + 2}."
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            zero = torch.zeros((), device=x.device)
            x = R.mm_op(R._linear, x.reshape(-1, 4 * d),
                        p[pre + "reduction.weight"], zero, q)
            x = _layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"],
                            eps).view(n, s_i // 2, s_i // 2, 2 * d)
    return x.mean((1, 2))


def serve_logits(enc: Params, head: Params, chips: torch.Tensor, m: dict,
                 mh: dict, q: R.Round = R.identity,
                 block: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(latents (N, 8 * embed_dim), the head's logits (N, classes)),
    float32, computed in blocks of ``block`` chips on the chips' device."""
    with R.no_tf32():
        zs, outs = [], []
        for lo in range(0, len(chips), block):
            z = latents(enc, m, chips[lo:lo + block], q)
            zs.append(z)
            outs.append(R.mlp(head, z, mh, q=q))
        return torch.cat(zs), torch.cat(outs)
