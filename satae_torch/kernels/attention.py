"""Attention of a ViT block, beside its plain version: for each chip and
head, softmax(q k^T / sqrt(d)) v over all of the chip's tokens.

The input is the block's qkv linear as K1 writes it, (chips * L, 3 * H *
d), token rows chip by chip and each row q, k, v of every head (timm's
``reshape(B, L, 3, H, d)``); the output is (chips * L, H * d), the heads
side by side, the input of the block's proj linear. On a CUDA tensor
:func:`attention` launches the hand-written kernel, counted in
``attention.launches`` and run inside the span ``satae.attn`` (counter
``tokens``); on a CPU tensor it computes :func:`attention_plain`, in
float32 or bf16. There is no fallback from one to the other.

The kernel (satae_torch/csrc/attention.cu; bf16 operands, float32 softmax
and sums, d = 64) is FlashAttention-3's forward for Hopper. Its bound on an
H100 is at the ridge: at Prithvi's 589 tokens a chip and block does 1.07
GFLOP against 3.6 MB of qkv and output, about 1.1 us each at the bf16 peak
and the memory rate, and at d = 64 the softmax's exponentials take the
special-function units about as long as the products take the tensor
cores. So the design keeps both busy at once: a persistent grid of
128-query tiles, one producer thread bringing Q, K and V by TMA from qkv in
place into a ring of stages, two consumer warpgroups on wgmma (S = Q K^T
from shared memory, O += P V with P from registers and V through wgmma's
transpose bit) that take turns, so one runs its softmax while the other's
products run, and S of the next key tile issued before this one's softmax.
"""

from __future__ import annotations

import math

import torch

from satae_torch.kernels import _build
from satae_torch.kernels.matmul import launch_span

HEAD_DIM = 64  # the kernel's head size


def _shape(qkv: torch.Tensor, chips: int, heads: int):
    if qkv.dim() != 2 or chips < 1 or heads < 1 \
            or qkv.shape[0] % chips or qkv.shape[1] % (3 * heads):
        raise ValueError(f"attention: qkv {tuple(qkv.shape)} is not (chips "
                         f"* L, 3 * heads * d) for {chips} chips and {heads} "
                         "heads")
    return qkv.shape[0] // chips, qkv.shape[1] // (3 * heads)


def attention_plain(qkv: torch.Tensor, chips: int,
                    heads: int) -> torch.Tensor:
    """The plain version: the textbook formula in float32 on qkv's values,
    the output rounded once to qkv's dtype."""
    L, d = _shape(qkv, chips, heads)
    q, k, v = qkv.float().view(chips, L, 3, heads, d).permute(2, 0, 3, 1, 4)
    p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return (p @ v).permute(0, 2, 1, 3).reshape(chips * L, heads * d) \
        .to(qkv.dtype)


def attention(qkv: torch.Tensor, chips: int, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of every chip and head of ``qkv`` (chips *
    L, 3 * heads * d) -> (chips * L, heads * d) in qkv's dtype. A CUDA qkv
    must be bf16 and contiguous, d = 64: one launch of the kernel; a CPU
    qkv takes :func:`attention_plain`. Raises on a refused launch."""
    L, d = _shape(qkv, chips, heads)
    if qkv.device.type == "cpu":
        return attention_plain(qkv, chips, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16 or d != HEAD_DIM \
            or not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"attention: the kernel takes a contiguous, "
                         f"16-byte-aligned bf16 qkv with heads of "
                         f"{HEAD_DIM}; got {qkv.dtype}, d = {d}")
    out = torch.empty((chips * L, heads * d), device=qkv.device,
                      dtype=qkv.dtype)
    with launch_span("satae.attn", attention, qkv.dtype, tokens=chips * L):
        _build.launch(_build.load("attention"), "satae_attention_bf16",
                      qkv.device, qkv.data_ptr(), out.data_ptr(), chips, L,
                      heads)
    return out


attention.launches = _build.launch_counter()
