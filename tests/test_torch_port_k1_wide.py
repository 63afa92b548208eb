"""K1's wide route on the CPU: the shape rule that picks it
(``satae_torch.kernels.matmul.k1_wide``) and its arithmetic.

The rule takes the ViT encoder's five bf16 linears at a 64-chip chunk and
no launch of the other main paths: every launch of
tests/test_torch_port_kernel_design.py's main-path tables (serving, the
batch-64 steps, decode, the stacked steps; bf16 and float32) keeps
``k1_loader``'s route. The wide kernel (satae_torch/csrc/gemm_wide.cu) runs
one float32 accumulator down all of K, so its arithmetic is that file's
``emulate_k1_bf16(..., per_slice=False, splits=1)``, held here against
satae's kernel (its Pallas kernel in interpret mode) at the ViT's K and N
with a small M, >= 99 % bit-equal and within the tolerance chip_smoke.py
holds the card to at those shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satae.kernels.matmul as KM
import test_torch_port_kernel_design as KD
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch.kernels import matmul as TM

_interpret_pallas = KD._interpret_pallas  # autouse: Pallas in interpret mode

# a 64-chip chunk: 589 tokens a chip (588 patches and the class token)
CHIPS, TOKENS, DIM, MLP = 64, 589, 768, 3072
ROWS = CHIPS * TOKENS
# the ViT's K1 launches (x shape, w shape): the patch embedding, then each
# block's qkv, proj, fc1 (GELU) and fc2, w the (K, N) buffers
# fast_infer._linear_weight makes
VIT = {"patch": ((CHIPS * 588, 1536), (1536, DIM)),
       "qkv": ((ROWS, DIM), (DIM, 3 * DIM)),
       "proj": ((ROWS, DIM), (DIM, DIM)),
       "fc1": ((ROWS, DIM), (DIM, MLP)),
       "fc2": ((ROWS, MLP), (MLP, DIM))}


def _buf(shape, dtype=torch.bfloat16):
    return KD._buffer(shape, dtype)


@pytest.mark.parametrize("launch", list(VIT))
def test_wide_route_takes_the_vit_launches(launch):
    x_shape, w_shape = VIT[launch]
    x, w = _buf(x_shape), _buf(w_shape)
    assert TM.k1_wide(x, w)
    assert TM.k1_wide(x, w, False, False)
    m, k = x_shape
    n = w_shape[1]
    assert TM.split_k_plan_tma(m, n, k)[2] == 1
    assert -(-m // TM.WIDE_TILE_M) * (n // TM.WIDE_TILE_N) >= 882


@pytest.mark.parametrize("launch", list(VIT))
@pytest.mark.parametrize("variant", ["float32", "batched", "trans_a",
                                     "trans_b", "misaligned"])
def test_wide_route_only_for_the_unbatched_bf16_layout(launch, variant):
    """The ViT's shapes off the rule's dtype, batching, layout or
    alignment keep k1_loader's route."""
    (m, k), (_, n) = VIT[launch]
    ta = tb = False
    if variant == "float32":
        x, w = _buf((m, k), torch.float32), _buf((k, n), torch.float32)
    elif variant == "batched":
        x, w = _buf((2, m, k)), _buf((2, k, n))
    elif variant == "trans_a":
        x, w, ta = _buf((k, m)), _buf((k, n)), True
    elif variant == "trans_b":
        x, w, tb = _buf((m, k)), _buf((n, k)), True
    else:  # one element into the allocation: no TMA
        x, w = KD._buffer((m, k), offset=1), _buf((k, n))
    assert not TM.k1_wide(x, w, ta, tb)


@pytest.mark.parametrize("launch", list(KD._AE_LAUNCHES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "float32"])
def test_main_path_launches_keep_their_route(launch, dtype):
    """Serving, the batch-64 AE and MLP steps, decode: N <= 128, or the
    decoder input's K = 64, or an operand read transposed."""
    x_shape, w_shape, ta, tb, *_ = KD._AE_LAUNCHES[launch]
    assert not TM.k1_wide(_buf(x_shape, dtype), _buf(w_shape, dtype), ta, tb)


@pytest.mark.parametrize("launch", list(KD._STACKED_AE_LAUNCHES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "float32"])
def test_stacked_launches_keep_their_route(launch, dtype):
    x_shape, w_shape, ta, tb, *_ = KD._STACKED_AE_LAUNCHES[launch]
    assert not TM.k1_wide(_buf(x_shape, dtype), _buf(w_shape, dtype), ta, tb)


@pytest.mark.parametrize("shape", list(KD._MAIN_PATH_TMA),
                         ids=[f"{m}x{k}x{n}" for m, k, n in KD._MAIN_PATH_TMA])
def test_bf16_wgmma_shapes_keep_their_route(shape):
    """Every bf16 product of the main paths on the 64 x 64 wgmma route, A
    row-major and B (K, N), stays there; so do the serving chunk's at
    8,192 rows (the throughput recipe) and the ViT head's."""
    m, k, n = shape
    assert not TM.k1_wide(_buf((m, k)), _buf((k, n)))


@pytest.mark.parametrize("shape", [
    (8192, 4096, 64), (8192, 64, 128), (8192, 128, 64), (8192, 64, 10),
    (8192, 64, 4096),  # the bf16 serving chunk and its decoder input
    (CHIPS, DIM, 128), (CHIPS, 128, 64), (CHIPS, 64, 10),  # the ViT head
], ids=lambda s: "x".join(map(str, s)))
def test_other_large_or_head_products_keep_their_route(shape):
    m, k, n = shape
    assert not TM.k1_wide(_buf((m, k)), _buf((k, n)))


@pytest.mark.parametrize("shape, want", [
    ((ROWS, 192, DIM), False),  # K not a multiple of the 64-deep stage...
    ((ROWS, 128, DIM), False),  # ... or below WIDE_MIN_K
    ((ROWS, 256, DIM), True),
    ((ROWS, DIM, 640), False),  # N not a multiple of 256
    ((4096, DIM, DIM), False),  # 96 tiles: less than a wave
    ((5632, DIM, DIM), True),  # 132 tiles
    ((5504, DIM, DIM), False),  # 129 tiles
], ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else None)
def test_wide_route_thresholds(shape, want):
    m, k, n = shape
    assert TM.k1_wide(_buf((m, k)), _buf((k, n))) == want


# ---- the wide kernel's arithmetic -------------------------------------------

def _satae_then_act(x, w, scale, shift, act):
    """satae's kernel on the bf16 operands' values (the product and the
    affine epilogue in float32), then ``act`` in float32 and one rounding
    to bf16: satae's kernel has no GELU."""
    as_j = lambda t: jnp.asarray(t.float().numpy())
    y = np.asarray(KM.fused_matmul(as_j(x), as_j(w), as_j(scale),
                                   as_j(shift), "none"))
    return TM.apply_act(torch.from_numpy(y), act).to(torch.bfloat16) \
        .float().numpy()


# the ViT's K and N at M = 128: qkv, fc2, fc1 with GELU
_WIDE_EMULATED = [((128, DIM, 3 * DIM), "none"), ((128, MLP, DIM), "none"),
                  ((128, DIM, MLP), "gelu")]


@pytest.mark.parametrize("case", _WIDE_EMULATED,
                         ids=[f"{m}x{k}x{n}-{a}" for (m, k, n), a
                              in _WIDE_EMULATED])
def test_emulated_wide_route_matches_satae(case):
    """One accumulator cut toward zero to float32 after every 16-deep step,
    down all of K (no split, no per-slice sums), against satae's kernel:
    >= 99 % bit-equal, and within chip_smoke.py's bf16 K1 tolerance at the
    ViT's shapes, one bf16 ulp + 1e-6 + 2^-18 of the sum of the products'
    magnitudes. The last term matters only near zero, and only at K =
    3,072: there the cuts toward zero of 192 steps add up to a few 1e-6
    (6 of 98,304 outputs, all under 2^-10 in magnitude, pass one ulp +
    1e-6 by up to 2.6x); at K = 768 every output is within one ulp +
    1e-6."""
    shape, act = case
    x, w, scale, shift, ref = KD._bf16_case(shape)
    want = ref(act) if act != "gelu" else _satae_then_act(x, w, scale, shift,
                                                          act)
    out = KD.emulate_k1_bf16(x, w, scale, shift, act, per_slice=False,
                             splits=1).float()
    r = torch.from_numpy(want)
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    mag = (x.float().abs() @ w.float().abs()) * scale
    d = (out - r).abs()
    bare = d / (ulp + 1e-6)
    assert float((d / (ulp + 1e-6 + 2.0 ** -18 * mag)).max()) <= 1.0
    assert float((d == 0).float().mean()) >= 0.99
    if shape[1] <= DIM:
        assert float(bare.max()) <= 1.0
    else:
        assert bool((r[bare > 1.0].abs() < 2.0 ** -10).all())
