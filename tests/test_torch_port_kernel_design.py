"""The design of kernels K1 and K2, checked on the CPU: K1's split-K plan,
the 3xTF32 arithmetic both kernels share, and the wrappers' host path.

The CUDA kernels run only on the card, where chip_smoke.py holds them against
their plain versions. Here a plain-PyTorch emulation of their arithmetic is
held against satae's ``fused_matmul`` (its Pallas kernel in interpret mode,
as in tests/test_torch_port_kernels.py), within the tolerance the port holds
on the card, 1e-4 + 1e-5*|ref|. The emulation follows gemm_tile.cuh: TF32
rounding done on the float32 bits (round to nearest, ties away, as
cvt.rna.tf32.f32), the three TF32 products of each 8-deep mma step, the
tensor cores' accumulation (the exact sum of the step's products and the
accumulator, cut toward zero to float32), a fresh accumulator per 32-deep
slice added to the running sum in float32, and the split-K partials summed
in split order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import satae.kernels.matmul as KM
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch.kernels import conv as TC
from satae_torch.kernels import matmul as TM
from satae_torch.nn import layers as TL

TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Force interpret mode for pallas_call on the CPU test platform."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero: add half of the dropped range to the magnitude bits, then clear
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def emulate_k1(x, w, scale, shift, act, *, terms=3, per_slice=True,
               splits=None, plan=None):
    """K1's arithmetic on float32 x (M, K), w (K, N): ``terms`` 3 is 3xTF32,
    1 a single TF32 product; ``per_slice`` False runs one accumulator down
    the whole split; ``splits`` overrides the mma.sync plan's split count,
    ``plan`` (splits, k_per_split) gives another, such as the wgmma
    route's."""
    m, k = x.shape
    n = w.shape[1]
    _, _, s_plan, kps = TM.split_k_plan(m, n, k)
    if splits is not None:
        s_plan, kps = splits, -(-k // splits)
    if plan is not None:
        s_plan, kps = plan
    xb, wb = tf32(x), tf32(w)
    xs, ws = tf32(x - xb), tf32(w - wb)
    pairs = [(xs, wb), (xb, ws), (xb, wb)] if terms == 3 else [(xb, wb)]
    total = torch.zeros(m, n)
    for s in range(s_plan):
        acc = torch.zeros(m, n)
        for k0 in range(s * kps, min(k, (s + 1) * kps), TM.BK):
            part = torch.zeros(m, n) if per_slice else acc
            for k8 in range(k0, min(k0 + TM.BK, k, (s + 1) * kps), 8):
                for a, b in pairs:
                    step = a[:, k8:k8 + 8].double() @ b[k8:k8 + 8].double()
                    part = toward_zero(part.double() + step)
            acc = acc + part if per_slice else part
        total = total + acc  # the partials in split order
    return TM.apply_act(total * scale + shift, act)


def _case(shape, seed=0):
    """Operands at the scale chip_smoke.py holds K1 at on the card: x
    N(0, 1), w U(-1, 1) / sqrt(K), scale U(0.5, 1.5), shift U(-0.3, 0.3)."""
    m, k, n = shape
    rng = np.random.default_rng(seed + m * 1000 + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(k, n)) / k ** 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    return x, w, scale, shift


def _satae(x, w, scale, shift, act):
    return np.asarray(KM.fused_matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(scale), jnp.asarray(shift),
                                      act))


def _emulated(x, w, scale, shift, act, **kw):
    return emulate_k1(*(torch.from_numpy(a) for a in (x, w, scale, shift)),
                      act, **kw).numpy()


def _within_tol(out, ref) -> bool:
    return bool(np.all(np.abs(out - ref)
                       <= TOL["atol"] + TOL["rtol"] * np.abs(ref)))


# ---- the split-K plan -----------------------------------------------------

# (M, K, N) of every K1 product on the main paths, and of K2's GEMM view
# at the encoder layers of a 512-image chunk, with the plan each gets:
# (tile_m, tile_n, splits, k_per_split)
_MAIN_PATH = {
    (512, 4096, 64): (64, 32, 8, 512),  # serving projection
    (64, 4096, 64): (64, 32, 32, 128),  # AE projection fwd, dec_in dX
    (512, 64, 128): (64, 64, 1, 64),  # serving fc0
    (512, 128, 64): (64, 64, 1, 128),  # serving fc1
    (512, 64, 10): (64, 32, 1, 64),  # serving fc2
    (64, 64, 4096): (64, 64, 1, 64),  # dec_in fwd, projection dX
    (4096, 64, 64): (64, 64, 1, 64),  # dec_in dW
    (64, 64, 128): (64, 64, 1, 64),  # head / MLP fc0 fwd
    (128, 64, 64): (64, 64, 1, 64),  # fc1 dW
    (64, 128, 10): (64, 32, 1, 128),  # fc2 fwd
    (10, 64, 128): (64, 64, 1, 64),  # fc2 dW
    (64, 10, 128): (64, 64, 1, 32),  # fc2 dX
    (524288, 27, 32): (64, 32, 1, 32),  # conv0
    (131072, 288, 64): (64, 64, 1, 288),  # conv1
    (32768, 576, 128): (64, 64, 1, 576),  # conv2
    (8192, 1152, 256): (64, 64, 1, 1152),  # conv3
}


@pytest.mark.parametrize("shape", list(_MAIN_PATH),
                         ids=[f"{m}x{k}x{n}" for m, k, n in _MAIN_PATH])
def test_split_k_plan_at_main_path_shapes(shape):
    m, k, n = shape
    assert TM.split_k_plan(m, n, k) == _MAIN_PATH[shape]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 20000), n=st.integers(1, 5000),
       k=st.integers(1, 10000))
def test_split_k_plan_covers_k_once_in_order(m, n, k):
    tile_m, tile_n, splits, kps = TM.split_k_plan(m, n, k)
    assert tile_m == TM.TILE_M and tile_n in (32, 64) and splits >= 1
    assert kps % TM.BK == 0
    ranges = [(s * kps, min(k, (s + 1) * kps)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)  # none empty
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # in order
    assert all(hi - lo == kps for lo, hi in ranges[:-1])
    tiles_own = -(-m // TM.TILE_M) * -(-n // TM.tile_n_for(n))
    if tiles_own >= TM.WAVE_BLOCKS or k < 2 * TM.MIN_SPLIT_K:
        assert splits == 1 and tile_n == TM.tile_n_for(n)
    if splits > 1:
        assert kps >= TM.MIN_SPLIT_K
        assert -(-m // tile_m) * -(-n // tile_n) * splits < 2 * TM.WAVE_BLOCKS
    ws = TM.split_k_workspace(m, n, splits, "meta")
    if splits == 1:
        assert ws is None
    else:
        assert ws.dtype == torch.float32
        assert ws.numel() * ws.element_size() == splits * m * n * 4


# ---- the arithmetic ---------------------------------------------------------

_EMULATED = [(64, 4096, 64), (7, 33, 10), (33, 1000, 10), (64, 4095, 64)]


@pytest.mark.parametrize("act", ["none", "relu", "sigmoid"])
@pytest.mark.parametrize("shape", _EMULATED,
                         ids=[f"{m}x{k}x{n}" for m, k, n in _EMULATED])
def test_emulated_3xtf32_split_k_matches_satae(shape, act):
    m, k, n = shape
    splits = TM.split_k_plan(m, n, k)[2]
    assert (splits > 1) == (k >= 2 * TM.MIN_SPLIT_K)  # the ragged ones split
    x, w, scale, shift = _case(shape)
    ref = _satae(x, w, scale, shift, act)
    out = _emulated(x, w, scale, shift, act)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


def test_one_tf32_product_misses_the_tolerance():
    """Why three TF32 products: one rounds each operand to 10 mantissa bits,
    and at K = 4096 the sum misses 1e-4 + 1e-5*|ref| by far."""
    x, w, scale, shift = _case((64, 4096, 64))
    ref = _satae(x, w, scale, shift, "none")
    one = _emulated(x, w, scale, shift, "none", terms=1)
    three = _emulated(x, w, scale, shift, "none")
    excess = np.abs(one - ref) / (TOL["atol"] + TOL["rtol"] * np.abs(ref))
    assert excess.max() > 4.0
    assert _within_tol(three, ref)


@pytest.mark.parametrize("per_slice", [True, False])
def test_one_accumulator_down_all_of_k_drifts(per_slice):
    """Why a fresh accumulator per 32-deep slice: the tensor cores' sums cut
    toward zero, so one accumulator that takes all 4096 of K in one split
    (as a product with >= 128 tiles does) drifts toward zero, here by ~30
    times the tolerance against the exact product (N(0, 1) operands, |out|
    ~ 64); per slice, the cut acts on small sums and the running sum is
    rounded, within it."""
    rng = np.random.default_rng(5)
    x, w = (rng.normal(size=s).astype(np.float32)
            for s in ((64, 4096), (4096, 64)))
    exact = x.astype(np.float64) @ w.astype(np.float64)
    out = _emulated(x, w, np.ones(64, np.float32), np.zeros(64, np.float32),
                    "none", per_slice=per_slice, splits=1)
    assert _within_tol(out, exact) == per_slice


# ---- the bf16 arithmetic ----------------------------------------------------

def emulate_k1_bf16(x, w, scale, shift, act, *, per_slice=True, splits=None,
                    plan=None):
    """K1's bf16 instantiation on bf16 x (M, K), w (K, N): each m16n8k16
    step adds 16 exact products to its accumulator and cuts the sum toward
    zero to float32; ``per_slice`` takes a fresh accumulator per 32-deep
    slice (two steps), added to the running sum with a rounded float32 add,
    else one accumulator runs down the split; the float32 partials are summed
    in split order, the float32 epilogue applied, the result rounded once to
    bf16 (to nearest even). The split plan is the one of the route
    ``TM.k1_loader`` picks for x and w: the wgmma kernel's (clusters of
    16 or 8 splits at K = 4096) for TMA-readable buffers, else the mma.sync
    loop's; ``plan`` (splits, k_per_split) gives another, such as a batched
    launch's. The wgmma kernel issues both slices of a 64-deep stage, also
    where K ends after the first, and adds only those inside K: the same
    sums."""
    m, k = x.shape
    n = w.shape[1]
    # the plan of the route the kernel takes for these buffers
    route = (TM.split_k_plan_tma if TM.k1_loader(x, w) == "tma"
             else TM.split_k_plan)
    _, _, s_plan, kps = route(m, n, k)
    if splits is not None:
        s_plan, kps = splits, -(-k // splits)
    if plan is not None:
        s_plan, kps = plan
    xd, wd = x.double(), w.double()  # bf16 products are exact in float64
    total = torch.zeros(m, n)
    for s in range(s_plan):
        acc = torch.zeros(m, n)
        for k0 in range(s * kps, min(k, (s + 1) * kps), TM.BK):
            part = torch.zeros(m, n) if per_slice else acc
            for k16 in range(k0, min(k0 + TM.BK, k, (s + 1) * kps), 16):
                step = xd[:, k16:k16 + 16] @ wd[k16:k16 + 16]
                part = toward_zero(part.double() + step)
            acc = acc + part if per_slice else part
        total = total + acc
    return TM.apply_act(total * scale + shift, act).to(torch.bfloat16)


def _bf16_case(shape):
    x, w, scale, shift = _case(shape)
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    ref = lambda act: np.asarray(KM.fused_matmul(
        xb, wb, jnp.asarray(scale), jnp.asarray(shift), act).astype(
            jnp.float32))
    as_t = lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16)
    return as_t(xb), as_t(wb), torch.from_numpy(scale), \
        torch.from_numpy(shift), ref


def _bf16_ulps(out: torch.Tensor, ref: np.ndarray):
    """(largest |out - ref| over one bf16 ulp of ref + 1e-6, share
    bit-equal). The 1e-6 covers values near zero, where the two float32
    sums' own rounding shows (chip_smoke.py holds the card to the same)."""
    r = torch.from_numpy(ref)
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    d = (out.float() - r).abs()
    return float((d / (ulp + 1e-6)).max()), float((d == 0).float().mean())


# the bf16 products of the main path, K = 4096 among them, and ragged K
_EMULATED_BF16 = [(64, 4096, 64), (512, 4096, 64), (64, 64, 128),
                  (64, 128, 10), (7, 33, 10), (1, 64, 10), (64, 4095, 64)]


@pytest.mark.parametrize("act", ["none", "relu", "sigmoid"])
@pytest.mark.parametrize("shape", _EMULATED_BF16,
                         ids=[f"{m}x{k}x{n}" for m, k, n in _EMULATED_BF16])
def test_emulated_bf16_split_k_matches_satae(shape, act):
    """The bf16 kernel's arithmetic against satae's kernel on the same bf16
    operands: within one bf16 ulp (+ 1e-6), >= 99 % bit-equal (measured:
    >= 99.98 %; both sum the exact products in float32, in other orders, and
    round once)."""
    x, w, scale, shift, ref = _bf16_case(shape)
    want = ref(act)
    ulps, equal = _bf16_ulps(emulate_k1_bf16(x, w, scale, shift, act), want)
    assert ulps <= 1.0 and equal >= 0.99, (ulps, equal)


@pytest.mark.parametrize("plan", ["mma.sync", "wgmma"])
@pytest.mark.parametrize("shape", [(64, 4096, 64), (512, 4096, 64)],
                         ids=["64x4096x64", "512x4096x64"])
def test_emulated_bf16_both_split_plans_match_satae(shape, plan):
    """The wgmma route's plan (16 splits of 256 / 8 of 512, one cluster)
    and the mma.sync loop's (32 of 128 / 8 of 512) both keep the kernel's
    sums within one bf16 ulp of satae's kernel, >= 99 % bit-equal: the
    split count only reorders float32 partial sums."""
    x, w, scale, shift, ref = _bf16_case(shape)
    m, k, n = shape
    splits = (TM.split_k_plan_tma if plan == "wgmma"
              else TM.split_k_plan)(m, n, k)[2]
    assert splits == ({64: 16, 512: 8} if plan == "wgmma"
                      else {64: 32, 512: 8})[m]
    ulps, equal = _bf16_ulps(emulate_k1_bf16(x, w, scale, shift, "relu",
                                             splits=splits), ref("relu"))
    assert ulps <= 1.0 and equal >= 0.99, (ulps, equal)


def test_bf16_keeps_a_fresh_accumulator_per_slice():
    """Why the bf16 main loop keeps gemm_tile.cuh's fresh accumulator per
    slice: without it, one accumulator cut toward zero down all of K = 4096
    (one split, as an 8192-row product takes) stays within one bf16 ulp of
    satae's kernel but loses bit-equality on ~0.4 % of the outputs (the bf16
    rounding amplifies the float32 drift across a rounding boundary); with
    it every output is bit-equal here."""
    x, w, scale, shift, ref = _bf16_case((64, 4096, 64))
    want = ref("none")
    one = _bf16_ulps(emulate_k1_bf16(x, w, scale, shift, "none",
                                     per_slice=False, splits=1), want)
    fresh = _bf16_ulps(emulate_k1_bf16(x, w, scale, shift, "none",
                                       splits=1), want)
    assert one[0] <= 1.0 and one[1] < 0.998, one
    assert fresh == (0.0, 1.0), fresh


# ---- the host path ----------------------------------------------------------

def test_null_scale_is_one_forward_and_backward():
    """fused_matmul with scale None computes what scale 1 computes, bitwise,
    and has no scale gradient; the CPU path is the plain version."""
    rng = np.random.default_rng(3)
    x, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((5, 12), (7, 12)))
    b = torch.from_numpy(rng.normal(size=7).astype(np.float32))
    grads = []
    for scale in (None, torch.ones(7)):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = TM.fused_matmul(leaves[0], leaves[1], scale, leaves[2], "relu",
                            w_nk=True)
        y.backward(torch.ones_like(y))
        grads.append((y.detach(), *(t.grad for t in leaves)))
    for a, c in zip(*grads):
        assert torch.equal(a, c)
    dx, dw, dscale, dshift = TM.fused_matmul_bwd_plain(
        torch.ones(5, 7), x, w, None, grads[0][0], "relu",
        needs=(True, True, False, True), w_nk=True)
    assert dscale is None and torch.equal(dshift, grads[0][3])


def test_linear_passes_no_scale(monkeypatch):
    """layers.linear allocates no ones for its scale: K1 gets None."""
    seen = []

    def spy(x, w, scale, shift, act="none", *, w_nk=False):
        seen.append(scale)
        return TM.fused_matmul(x, w, scale, shift, act, w_nk=w_nk)

    monkeypatch.setattr(TL, "fused_matmul", spy)
    x, w, b = torch.randn(3, 4), torch.randn(2, 4), torch.randn(2)
    torch.testing.assert_close(TL.linear(x, w, b, "relu"),
                               TL.linear_plain(x, w, b, "relu"))
    assert seen == [None]


# ---- the bf16 wgmma route: plan and loaders ----------------------------------

# (M, K, N) of every bf16 K1 product on the main paths that runs on the
# wgmma route, with split_k_plan_tma's plan: (tile_m, tile_n, splits,
# k_per_split); the splits of a tile are one cluster
_MAIN_PATH_TMA = {
    (512, 4096, 64): (64, 64, 8, 512),  # serving projection
    (64, 4096, 64): (64, 64, 16, 256),  # AE projection fwd, dec_in dX
    (2048, 4096, 64): (64, 64, 2, 2048),  # extraction projection
    (64, 64, 4096): (64, 64, 1, 64),  # dec_in fwd, projection dX / dW
    (512, 64, 4096): (64, 64, 1, 64),  # decoder input at chunk 512
    (4096, 64, 64): (64, 64, 1, 64),  # dec_in dW
    (64, 64, 128): (64, 64, 1, 64),  # head fc1 fwd
    (64, 128, 64): (64, 64, 1, 128),  # fc1 dX
    (128, 64, 64): (64, 64, 1, 64),  # fc1 dW
    (64, 128, 10): (64, 64, 1, 128),  # fc2 fwd
}


@pytest.mark.parametrize("shape", list(_MAIN_PATH_TMA),
                         ids=[f"{m}x{k}x{n}" for m, k, n in _MAIN_PATH_TMA])
def test_tma_plan_at_main_path_shapes(shape):
    m, k, n = shape
    assert TM.split_k_plan_tma(m, n, k) == _MAIN_PATH_TMA[shape]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 20000), n=st.integers(1, 5000),
       k=st.integers(1, 10000))
def test_tma_plan_covers_k_once_in_order(m, n, k):
    """Split s covers [s * kps, min(k, (s + 1) * kps)): every range
    non-empty, in order, K covered once; kps a multiple of the 64-deep TMA
    stage, so no stage straddles two splits; at most 16 splits (one
    cluster per tile); one split once the tiles fill a wave or K is
    short."""
    tile_m, tile_n, splits, kps = TM.split_k_plan_tma(m, n, k)
    assert (tile_m, tile_n) == (64, 64)
    assert 1 <= splits <= TM.MAX_CLUSTER and kps % TM.TMA_BK == 0
    ranges = [(s * kps, min(k, (s + 1) * kps)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles = -(-m // 64) * -(-n // 64)
    if tiles >= TM.TMA_WAVE_BLOCKS or k < 2 * TM.TMA_MIN_SPLIT_K:
        assert splits == 1
    if splits > 1:
        assert kps >= TM.TMA_MIN_SPLIT_K
        assert tiles * splits < 2 * TM.TMA_WAVE_BLOCKS


def _buffer(shape, dtype=torch.bfloat16, offset=0):
    """A contiguous CPU buffer of ``shape`` starting ``offset`` elements into
    its storage (a 64-byte-aligned allocation)."""
    store = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    return store[offset:].view(shape)


# the buffers of each K1 launch of a batch-64 AE step, the decoder input and
# the serving projection, as fused_gemm gets them (x, w, trans_a, trans_b),
# and the loader each takes in bf16 and in float32: fc2's dX and dW (20- and
# 40-byte rows) on the mma.sync loop in both; in float32 also the head's
# forward (N = 10) and the serving projection (8 splits of 512), which
# `chip_smoke.py --ab` timed faster there (k1_loader's rules)
_AE_LAUNCHES = {
    "proj fwd": ((64, 4096), (64, 4096), False, True, "tma", "tma"),
    "proj dX": ((64, 64), (64, 4096), False, False, "tma", "tma"),
    "proj dW": ((64, 64), (64, 4096), True, False, "tma", "tma"),
    "dec_in fwd": ((64, 64), (4096, 64), False, True, "tma", "tma"),
    "dec_in dX": ((64, 4096), (4096, 64), False, False, "tma", "tma"),
    "dec_in dW": ((64, 4096), (64, 64), True, False, "tma", "tma"),
    "fc1 fwd": ((64, 64), (128, 64), False, True, "tma", "tma"),
    "fc1 dX": ((64, 128), (128, 64), False, False, "tma", "tma"),
    "fc1 dW": ((64, 128), (64, 64), True, False, "tma", "tma"),
    "fc2 fwd": ((64, 128), (10, 128), False, True, "tma", "cp.async"),
    "fc2 dX": ((64, 10), (10, 128), False, False, "cp.async", "cp.async"),
    "fc2 dW": ((64, 10), (64, 128), True, False, "cp.async", "cp.async"),
    "decode dec_in": ((512, 64), (4096, 64), False, True, "tma", "tma"),
    "serve proj": ((512, 4096), (4096, 64), False, False, "tma", "cp.async"),
}


@pytest.mark.parametrize("launch", list(_AE_LAUNCHES))
def test_k1_loader_at_main_path_launches(launch):
    x_shape, w_shape, ta, tb, want, want_f32 = _AE_LAUNCHES[launch]
    assert TM.k1_loader(_buffer(x_shape), _buffer(w_shape), ta, tb) == want
    assert TM.k1_loader(_buffer(x_shape, torch.float32),
                        _buffer(w_shape, torch.float32), ta, tb) == want_f32


@pytest.mark.parametrize("case", [
    ((64, 4096), (4096, 64), 1, "cp.async"),  # odd element offset
    ((33, 40), (40, 24), 3, "cp.async"),
    ((33, 40), (40, 24), 8, "tma"),  # 16 bytes in: aligned again
    ((7, 33), (33, 10), 0, "cp.async"),  # odd K
    ((33, 1001), (1001, 11), 0, "cp.async"),
    ((100, 4100), (70, 4100), 0, "cp.async"),  # K = 4100: 8,200-byte rows
    ((96, 4096), (4096, 70), 0, "cp.async"),  # N = 70: 140-byte rows
    ((96, 4096), (70, 4096), 0, "tma"),
    ((1, 64), (64, 8), 0, "tma"),
    ((130, 4160), (4160, 72), 0, "tma"),
], ids=lambda c: f"{c[0]}x{c[1]}+{c[2]}" if isinstance(c, tuple) else None)
def test_k1_loader_by_alignment(case):
    """The phase-13 cases: the wrapper takes TMA only for 16-byte-aligned
    bases and rows, before the launch, from the buffers alone."""
    x_shape, w_shape, offset, want = case
    x = _buffer(x_shape, offset=offset)
    w = _buffer(w_shape, offset=offset)
    assert TM.k1_loader(x, w) == want


# the buffers of each K1 launch of a stacked AE step (C = 45) as
# fused_gemm gets them over the config axis (x, w, trans_a, trans_b): forward x @ W^T
# with the (out, in) weights read in place, dX = gs @ W, dW = gs^T @ x (gs
# read transposed); and the loader each takes in bf16 and in float32
_STACKED_AE_LAUNCHES = {
    "proj fwd": ((45, 64, 4096), (45, 64, 4096), False, True, "tma", "tma"),
    "proj dX": ((45, 64, 64), (45, 64, 4096), False, False, "tma",
                "cp.async"),
    "proj dW": ((45, 64, 64), (45, 64, 4096), True, False, "tma",
                "cp.async"),
    "dec_in fwd": ((45, 64, 64), (45, 4096, 64), False, True, "tma", "tma"),
    "dec_in dX": ((45, 64, 4096), (45, 4096, 64), False, False, "tma",
                  "cp.async"),
    "dec_in dW": ((45, 64, 4096), (45, 64, 64), True, False, "tma",
                  "cp.async"),
    "fc1 fwd": ((45, 64, 64), (45, 128, 64), False, True, "tma", "tma"),
    "fc1 dX": ((45, 64, 128), (45, 128, 64), False, False, "tma", "tma"),
    "fc1 dW": ((45, 64, 128), (45, 64, 64), True, False, "tma", "tma"),
    "fc2 fwd": ((45, 64, 128), (45, 10, 128), False, True, "tma",
                "cp.async"),
    "fc2 dX": ((45, 64, 10), (45, 10, 128), False, False, "cp.async",
               "cp.async"),  # 20-byte rows
    "fc2 dW": ((45, 64, 10), (45, 64, 128), True, False, "cp.async",
               "cp.async"),
}


@pytest.mark.parametrize("launch", list(_STACKED_AE_LAUNCHES))
def test_k1_loader_at_stacked_ae_launches(launch):
    """The 3-D form of the loader at the vmap path's launches: in bf16
    every launch on the wgmma route but fc2's dX and dW, as on the
    unbatched route; in float32 also the 4096-wide dX and dW (an MN-major
    B, 2^24 multiply-adds a config) and the head's forward on the mma.sync
    loop, which `chip_smoke.py --ab` timed faster there."""
    x_shape, w_shape, ta, tb, want, want_f32 = _STACKED_AE_LAUNCHES[launch]
    assert TM.k1_loader(_buffer(x_shape), _buffer(w_shape), ta, tb) == want
    assert TM.k1_loader(_buffer(x_shape, torch.float32),
                        _buffer(w_shape, torch.float32), ta, tb) == want_f32


def _stack(shape, config_stride, offset=0):
    """C buffers of (M, K) bf16 whose config c starts ``config_stride``
    elements after config c - 1, ``offset`` elements into a 64-byte-aligned
    allocation."""
    c, m, k = shape
    store = torch.zeros(c * config_stride + offset, dtype=torch.bfloat16)
    return store[offset:].as_strided(shape, (config_stride, k, 1))


@pytest.mark.parametrize("case", [
    ((3, 64, 64), 64 * 64, 0, "tma"),
    ((3, 64, 64), 64 * 64, 1, "cp.async"),  # odd element offset
    ((3, 64, 64), 64 * 64, 8, "tma"),  # 16 bytes in: aligned again
    ((3, 64, 64), 64 * 64 + 1, 0, "cp.async"),  # odd config stride
    ((3, 64, 64), 64 * 64 + 8, 0, "tma"),  # a 16-byte-multiple stride
    ((3, 7, 40), 7 * 40 + 4, 0, "cp.async"),  # 8-byte config stride
    ((3, 64, 10), 64 * 10, 0, "cp.async"),  # 20-byte rows
], ids=lambda c: f"{c[0]}+{c[1]}@{c[2]}" if isinstance(c, tuple) else None)
def test_batched_k1_loader_by_alignment(case):
    """A stack leaves TMA for an odd base, row or config stride: TMA reads
    a 3-D map whose strides are 16-byte multiples from a 16-byte-aligned
    base. Either operand decides."""
    shape, config_stride, offset, want = case
    x = _stack(shape, config_stride, offset)
    w = _buffer((3, shape[2], 64))
    assert TM.k1_loader(x, w) == want
    assert TM.k1_loader(w, x) == want


# (C, M, K, N, act) of batched bf16 products on the wgmma route, each with
# split_k_plan_tma's batched plan: the vmap path's long-K product at C = 45
# (4 splits of 1024 per config, where one product alone takes 16), a plan
# of 6 splits whose last is shorter, and a short-K one-split product with
# ragged M and N
_BATCHED_EMULATED = [(45, 8, 4096, 16, "none"), (30, 64, 4096, 64, "relu"),
                     (7, 40, 64, 72, "sigmoid")]


@pytest.mark.parametrize("case", _BATCHED_EMULATED,
                         ids=[f"C{c}_{m}x{k}x{n}"
                              for c, m, k, n, _ in _BATCHED_EMULATED])
def test_emulated_batched_bf16_plan_matches_vmapped_satae(case):
    """The wgmma kernel's arithmetic, per config on the batched TMA plan,
    against jax.vmap of satae's kernel in bf16 (interpret mode): within one
    bf16 ulp (+ 1e-6), >= 99 % bit-equal in every config."""
    c, m, k, n, act = case
    parts = [_case((m, k, n), seed=i) for i in range(c)]
    x, w, scale, shift = (np.stack(a) for a in zip(*parts))
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    ref = np.asarray(jax.vmap(
        lambda a, b, sc, sh: KM.fused_matmul(a, b, sc, sh, act))(
            xb, wb, jnp.asarray(scale), jnp.asarray(shift)).astype(
                jnp.float32))
    xt, wt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (xb, wb))
    assert TM.k1_loader(xt, wt) == "tma"
    _, _, splits, kps = TM.split_k_plan_tma(m, n, k, batch=c)
    assert (splits, kps) == {4096: (4, 1024) if c == 45 else (6, 704),
                             64: (1, 64)}[k]
    for i in range(c):
        out = emulate_k1_bf16(xt[i], wt[i], torch.from_numpy(scale[i]),
                              torch.from_numpy(shift[i]), act,
                              plan=(splits, kps))
        ulps, equal = _bf16_ulps(out, ref[i])
        assert ulps <= 1.0 and equal >= 0.99, (i, ulps, equal)


@pytest.mark.parametrize("case", [
    ((512, 64, 64, 3), 32, ("rows", 32), ("rows", 32)),  # conv0
    ((512, 32, 32, 32), 64, ("im2col", 64), ("im2col", 64)),  # conv1
    ((512, 16, 16, 64), 128, ("im2col", 128), ("im2col", 64)),  # conv2
    ((512, 8, 8, 128), 256, ("im2col", 128), ("im2col", 64)),  # conv3
    ((3, 7, 7, 5), 9, ("mma", 32), ("mma", 32)),
    ((2, 9, 9, 6), 40, ("mma", 64), ("mma", 64)),
    # Cin 8: no 32-channel load
    ((3, 11, 11, 8), 72, ("mma", 64), ("mma", 64)),
    # Cout 40 > 32: not the rows kernel
    ((2, 10, 10, 3), 40, ("mma", 64), ("mma", 64)),
    ((5, 13, 13, 16), 24, ("mma", 32), ("mma", 32)),
    ((4, 32, 32, 3), 16, ("rows", 32), ("rows", 32)),
    ((2, 9, 9, 64), 72, ("im2col", 128), ("im2col", 64)),
    ((3, 12, 12, 128), 64, ("im2col", 64), ("im2col", 64)),
    # Cin 32, Cout > 64: bf16's 64-wide tile takes Cout <= 64
    ((2, 9, 9, 32), 72, ("mma", 64), ("im2col", 64)),
    ((3, 7, 7, 32), 40, ("im2col", 64), ("im2col", 64)),
    # 5 x 5 outputs: not whole rows
    ((2, 10, 10, 3), 32, ("mma", 32), ("mma", 32)),
], ids=lambda c: f"{c[0]}-{c[1]}" if isinstance(c, tuple) else None)
def test_conv_route(case):
    """K2's route for the phase-13 layers (stride 2, padding 1), bf16 and
    float32 (whose im2col kernel takes Cin a multiple of 32 at any Cout,
    on 64-wide tiles)."""
    x_shape, cout, want, want_f32 = case
    w_shape = (3, 3, x_shape[3], cout)
    assert TC.conv_route(_buffer(x_shape), _buffer(w_shape), 2, 1) == want
    f32 = TC.conv_route(_buffer(x_shape, torch.float32),
                        _buffer(w_shape, torch.float32), 2, 1)
    assert f32 == want_f32
    # a misaligned input leaves the wgmma kernels, and so does a stride
    # beyond TMA's im2col mode
    for dtype in (torch.bfloat16, torch.float32):
        assert TC.conv_route(_buffer(x_shape, dtype, offset=1),
                             _buffer(w_shape, dtype), 2, 1)[0] == "mma"
        assert TC.conv_route(_buffer(x_shape, dtype),
                             _buffer(w_shape, dtype), 9, 1)[0] in (
            "rows", "mma")
