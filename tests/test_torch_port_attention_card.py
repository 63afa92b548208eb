"""The ViT's attention kernel on a CUDA card (marker ``card``; each test
skips where there is no card): at the main path's chunk (64 chips of 589
tokens, 12 heads of 64) and at the shapes where its tiles of 128 queries
and 128 keys meet an edge -- one token, a chip boundary inside a tile, the
last key tile holding 1, 13 or 77 keys, a single query tile, L a multiple
of 128 and one past it -- the kernel is within one bf16 ulp + 2^-8 sum_j
p_j |v_j| + 1e-6 of :func:`attention_plain` on the same card, finite, one
launch a call, and two calls are bitwise equal.

tests/conftest.py imports JAX, which the card's machine does not have, so
run this file there without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \
        tests/test_torch_port_attention_card.py
"""

import pytest
import torch

from satae_torch.kernels.attention import attention, attention_plain

pytestmark = pytest.mark.card

# (chips, tokens, heads)
SHAPES = [(64, 589, 12), (3, 77, 2), (2, 1, 1), (2, 64, 1), (2, 65, 3),
          (2, 128, 1), (2, 129, 1), (1, 1024, 12)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernel runs only there")
    return torch.device("cuda")


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``ref``: 2^(floor(log2 |v|) - 7), 0 at
    0."""
    r = ref.float().abs()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return torch.where(r > 0, ulp, torch.zeros_like(r))


@pytest.mark.parametrize("chips,tokens,heads", SHAPES,
                         ids=[f"{c}x{t}x{h}" for c, t, h in SHAPES])
def test_kernel_is_the_plain_version(card, chips, tokens, heads):
    g = torch.Generator(device=card).manual_seed(
        chips * 100_000 + tokens * 100 + heads)
    # qkv at the scale a block's LayerNorm'd input gives it
    qkv = (torch.randn(chips * tokens, 3 * heads * 64, generator=g,
                       device=card) * 1.5).to(torch.bfloat16)
    before = attention.launches["_bf16"]
    out = attention(qkv, chips, heads)
    assert attention.launches["_bf16"] == before + 1
    assert out.shape == (chips * tokens, heads * 64)
    assert out.dtype == torch.bfloat16
    ref = attention_plain(qkv, chips, heads)
    # P is rounded to bf16 (2^-9 of each weight) before P V, so an output's
    # error scales with sum_j p_j |v_j| (the plain version on |v|), then
    # the output's own rounding
    e = 2 * heads * 64
    scale = attention_plain(torch.cat([qkv[:, :e], qkv[:, e:].abs()], 1),
                            chips, heads).float()
    lim = bf16_ulp(ref) + scale * 2.0 ** -8 + 1e-6
    err = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((err <= lim).all()), \
        f"max |err| {float(err.max()):.3g}, {float((err / lim).max()):.3g} " \
        "x the bound"
    assert torch.equal(out, attention(qkv, chips, heads))
