"""Shifted-window cosine attention of a Swin Transformer V2 block, beside
its plain version: for each chip, window and head, softmax(cos(q_i, k_j) *
scale + bias[i][j] (- 100 across a shifted window's regions)) v over the
window's tokens.

The input is the block's qkv linear as K1 writes it, (chips * side^2, 3 *
H * d): token rows chip by chip in (row, column) order of the unrolled
grid, each row q, k, v of every head (torchvision's ``reshape(B, L, 3, H,
d)``); the output is (chips * side^2, H * d) in the same row order, the
input of the block's proj linear. The roll by (-shift, -shift), the cut
into window x window windows and their inverses are index arithmetic: no
copy of the activations is made for them. ``bias`` (H, window^2,
window^2) float32 is the folded continuous position bias (16 sigmoid of
the CPB MLP at each pair's offset), ``scale`` (H,) float32 each head's
exp(min(logit_scale, ln 100)).

On a CUDA tensor :func:`window_attention` launches the hand-written kernel
(satae_torch/csrc/window_attention.cu: bf16 qkv, d = 32, 8 x 8 windows),
counted in ``window_attention.launches`` and run inside the span
``satae.wattn`` (counters ``windows``, the chips' windows, and ``shifted``,
1 for a shifted block); on a CPU tensor it computes
:func:`window_attention_plain`, in float32 or bf16. There is no fallback
from one to the other.
"""

from __future__ import annotations

import torch

from satae_torch.kernels import _build
from satae_torch.kernels.matmul import launch_span

HEAD_DIM = 32  # the kernel's head size
WINDOW = 8  # the kernel's window side


def _shape(qkv, chips, side, heads, window, shift, bias, scale) -> int:
    """Check the arguments; the head size."""
    if qkv.dim() != 2 or chips < 1 or heads < 1 or side < window \
            or side % window or qkv.shape[0] != chips * side * side \
            or qkv.shape[1] % (3 * heads):
        raise ValueError(f"window_attention: qkv {tuple(qkv.shape)} is not "
                         f"(chips * side^2, 3 * heads * d) for {chips} chips "
                         f"of side {side} in windows of {window} and {heads} "
                         "heads")
    if not 0 <= shift < window or (shift and side == window):
        raise ValueError(f"window_attention: shift {shift} for side {side} "
                         f"and window {window}")
    n = window * window
    if bias.shape != (heads, n, n) or scale.shape != (heads,) \
            or bias.dtype != torch.float32 or scale.dtype != torch.float32:
        raise ValueError(f"window_attention: bias {tuple(bias.shape)} "
                         f"{bias.dtype} and scale {tuple(scale.shape)} "
                         f"{scale.dtype}: expected float32 ({heads}, {n}, "
                         f"{n}) and ({heads},)")
    return qkv.shape[1] // (3 * heads)


def region_labels(side: int, window: int, shift: int,
                  device=None) -> torch.Tensor:
    """(side^2,) the region of each token of the rolled grid in its shifted
    window, as torchvision's mask: along each axis 0 before side - window,
    1 before side - shift, 2 after; a token's label is 3 * row's + column's.
    Tokens of one window attend across labels only at -100."""
    r = torch.zeros(side, dtype=torch.long, device=device)
    r[side - window:side - shift] = 1
    r[side - shift:] = 2
    return (r[:, None] * 3 + r[None, :]).reshape(-1)


def window_attention_plain(qkv: torch.Tensor, chips: int, side: int,
                           heads: int, window: int, shift: int,
                           bias: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The plain version: the roll, the windows, the scores q k^T scaled by
    scale / |q_i| and 1 / |k_j|, the bias and mask, the softmax and P v in
    float32 on qkv's values, the output rounded once to qkv's dtype and put
    back at its tokens' rows."""
    d = _shape(qkv, chips, side, heads, window, shift, bias, scale)
    c, nw, n = heads * d, side // window, window * window
    x = qkv.float().view(chips, side, side, 3 * c)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = x.view(chips, nw, window, nw, window, 3, heads, d) \
        .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, chips, nw * nw, heads, n,
                                                  d)
    q, k, v = x
    inv = lambda t: 1.0 / torch.clamp(t.norm(dim=-1), min=1e-12)
    s = (q @ k.transpose(-1, -2)) \
        * (scale.view(heads, 1) * inv(q)).unsqueeze(-1) \
        * inv(k).unsqueeze(-2) + bias
    if shift:
        lab = region_labels(side, window, shift, qkv.device) \
            .view(nw, window, nw, window).permute(0, 2, 1, 3) \
            .reshape(nw * nw, n)
        s = s - 100.0 * (lab[:, None, :, None] != lab[:, None, None, :])
    o = torch.softmax(s, dim=-1) @ v  # (chips, windows, heads, n, d)
    o = o.view(chips, nw, nw, heads, window, window, d) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(chips, side, side, c)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return o.reshape(chips * side * side, c).to(qkv.dtype)


def window_attention(qkv: torch.Tensor, chips: int, side: int, heads: int,
                     window: int, shift: int, bias: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """The block's shifted-window attention of ``qkv`` (chips * side^2, 3 *
    heads * d) -> (chips * side^2, heads * d) in qkv's dtype, as the module
    docstring says. A CUDA qkv must be bf16, contiguous and 16-byte
    aligned, d = 32, window 8, bias and scale contiguous on its device: one
    launch of the kernel; a CPU qkv takes :func:`window_attention_plain`.
    Raises on a refused launch."""
    d = _shape(qkv, chips, side, heads, window, shift, bias, scale)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, chips, side, heads, window, shift,
                                      bias, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for device "
                         f"{qkv.device}")
    if qkv.dtype != torch.bfloat16 or d != HEAD_DIM or window != WINDOW \
            or not qkv.is_contiguous() or qkv.data_ptr() % 16 \
            or any(t.device != qkv.device or not t.is_contiguous()
                   for t in (bias, scale)):
        raise ValueError(f"window_attention: the kernel takes a contiguous, "
                         f"16-byte-aligned bf16 qkv with heads of {HEAD_DIM} "
                         f"in windows of {WINDOW}, bias and scale on its "
                         f"device; got {qkv.dtype}, d = {d}, window {window}")
    out = torch.empty((qkv.shape[0], heads * d), device=qkv.device,
                      dtype=qkv.dtype)
    with launch_span("satae.wattn", window_attention, qkv.dtype,
                     windows=chips * (side // window) ** 2,
                     shifted=int(shift > 0)):
        _build.launch(_build.load("window_attention"),
                      "satae_window_attention_bf16", qkv.device,
                      qkv.data_ptr(), bias.data_ptr(), scale.data_ptr(),
                      out.data_ptr(), chips, side, heads, shift)
    return out


window_attention.launches = _build.launch_counter()
