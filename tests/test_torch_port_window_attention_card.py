"""The Swin encoder's kernels on a CUDA card (marker ``card``; each test
skips where there is no card): the window-attention kernel at the four
stage shapes of a 64-chip chunk of SatlasPretrain's Swin-v2-B at 512 px
(sides 128, 64, 32, 16; 4, 8, 16 and 32 heads), shifted and not, and at
edge shapes -- one window, a side of three windows, one chip, the shift's
seam in a grid of two windows -- is within one bf16 ulp + 2^-8 sum_j p_j
|v_j| + 1e-6 of :func:`window_attention_plain` on the same card, finite,
one launch a call, and two calls are bitwise equal; the LayerNorm kernel's
post mode at the stages' widths is within one bf16 ulp (and 2^-16 of the
sum's size, where the add cancels) of :func:`layer_norm_post_plain`.

tests/conftest.py imports JAX, which the card's machine does not have, so
run this file there without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \
        tests/test_torch_port_window_attention_card.py
"""

import math

import pytest
import torch

from satae_torch.kernels.layernorm import (layer_norm_post,
                                           layer_norm_post_plain)
from satae_torch.kernels.window_attention import (window_attention,
                                                  window_attention_plain)

pytestmark = pytest.mark.card

# (chips, side, heads, shift)
SHAPES = [(64, 128, 4, 0), (64, 128, 4, 4), (64, 64, 8, 4), (64, 32, 16, 4),
          (64, 16, 32, 0), (64, 16, 32, 4), (1, 8, 1, 0), (2, 24, 3, 4),
          (1, 16, 2, 4), (3, 16, 5, 2)]
# (rows, width)
LN_SHAPES = [(1_048_576, 128), (262_144, 256), (65_536, 512), (16_384, 1024),
             (1, 128), (13, 1024), (1001, 520)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Swin encoder's kernels run only "
                    "there")
    return torch.device("cuda")


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``ref``: 2^(floor(log2 |v|) - 7), 0 at
    0."""
    r = ref.float().abs()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return torch.where(r > 0, ulp, torch.zeros_like(r))


def _inputs(card, chips, side, heads, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    c = 32 * heads
    # qkv at the scale a post-norm residual stream gives it
    qkv = (torch.randn(chips * side * side, 3 * c, generator=g, device=card)
           * 1.5).to(torch.bfloat16)
    bias = 16 * torch.sigmoid(torch.randn(heads, 64, 64, generator=g,
                                          device=card))
    tau = torch.rand(heads, generator=g, device=card) \
        * (math.log(100.0) + 0.5 - math.log(10.0)) + math.log(10.0)
    scale = torch.clamp(tau, max=math.log(100.0)).exp()
    return qkv, bias, scale


@pytest.mark.parametrize("chips,side,heads,shift", SHAPES,
                         ids=[f"{c}x{s}x{h}s{t}" for c, s, h, t in SHAPES])
def test_window_kernel_is_the_plain_version(card, chips, side, heads, shift):
    qkv, bias, scale = _inputs(card, chips, side, heads,
                               chips * 100_000 + side * 100 + heads + shift)
    before = window_attention.launches["_bf16"]
    out = window_attention(qkv, chips, side, heads, 8, shift, bias, scale)
    assert window_attention.launches["_bf16"] == before + 1
    assert out.shape == (chips * side * side, heads * 32)
    assert out.dtype == torch.bfloat16
    ref = window_attention_plain(qkv, chips, side, heads, 8, shift, bias,
                                 scale)
    # P is rounded to bf16 (2^-9 of each weight) before P V, so an output's
    # error scales with sum_j p_j |v_j| (the plain version on |v|), then
    # the output's own rounding; the scores' float32 sums differ in order
    # only (~1e-6 relative, times a scale of at most 100)
    e = 2 * heads * 32
    mag = window_attention_plain(torch.cat([qkv[:, :e], qkv[:, e:].abs()], 1),
                                 chips, side, heads, 8, shift, bias,
                                 scale).float()
    lim = bf16_ulp(ref) + mag * 2.0 ** -8 + 1e-6
    err = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((err <= lim).all()), \
        f"max |err| {float(err.max()):.3g}, {float((err / lim).max()):.3g} " \
        "x the bound"
    assert torch.equal(out, window_attention(qkv, chips, side, heads, 8,
                                             shift, bias, scale))


def test_window_kernel_refuses_what_it_does_not_take(card):
    qkv, bias, scale = _inputs(card, 1, 16, 2, 7)
    with pytest.raises(ValueError, match="bf16"):
        window_attention(qkv.float(), 1, 16, 2, 8, 0, bias, scale)
    with pytest.raises(ValueError, match="shift"):
        window_attention(qkv, 1, 8 * 2, 2, 8, 8, bias, scale)


@pytest.mark.parametrize("rows,width", LN_SHAPES,
                         ids=[f"{m}x{n}" for m, n in LN_SHAPES])
def test_layernorm_post_is_the_plain_version(card, rows, width):
    g = torch.Generator(device=card).manual_seed(rows + width)
    h = (torch.randn(rows, width, generator=g, device=card) * 3) \
        .to(torch.bfloat16)
    x = (torch.randn(rows, width, generator=g, device=card) * 0.7 + 0.2) \
        .to(torch.bfloat16)
    w = torch.randn(width, generator=g, device=card) * 0.1 + 1.0
    b = torch.randn(width, generator=g, device=card) * 0.1
    want = layer_norm_post_plain(h.clone(), x, w, b, 1e-5)
    got = h.clone()
    assert layer_norm_post(got, x, w, b, 1e-5) is got
    # the same float32 arithmetic, the row's sums in another order: the
    # float32 sums differ by ~1e-6 of |h| + |LN(x)| (at most ~6 here), then
    # each is rounded once to bf16, so a result differs by one ulp, or where
    # the add cancels to near 0 (an ulp of ~0) by that float32 difference
    lim = bf16_ulp(want) + 2.0 ** -16 * (h.float().abs() + 8.0)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    again = h.clone()
    layer_norm_post(again, x, w, b, 1e-5)
    assert torch.equal(got, again)
