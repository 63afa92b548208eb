"""The float32 route of K1 and K2 on Hopper's wgmma (3xTF32), checked on the
CPU: its split plan, the K-major float32 fold, the kernels' arithmetic on
the new plan against satae's kernel, the index maps of the split pass that
lays operands out for the tensor cores, and each float32 main-path
launch's route.

The CUDA kernels (satae_torch/csrc/wgmma_tile.cuh: consume_tf32; the float32
instantiations of fused_gemm_tma_kernel, conv_im2col_tma_kernel and
conv_rows_kernel) run only on the card, where chip_smoke.py holds them
against their plain versions. Here their arithmetic -- big = tf32_rna(v),
small = tf32_rna(v - big), per 8-deep step small*big, big*small and
big*big into a fresh accumulator per 32-deep stage (cut toward zero, the
tensor cores' accumulation), added to the running float32 sum, the
cluster's split partials summed in split order -- is emulated on the wgmma
route's plan (tests/test_torch_port_kernel_design.py::emulate_k1) and held
against satae's ``_mm_kernel`` in interpret mode within 1e-4 +
1e-5*|ref|, the tolerance the port holds on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import satae.kernels.matmul as KM
from test_torch_port_kernel_design import (TOL, _buffer, _case, emulate_k1,
                                           tf32)
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TCfg
from satae_torch.kernels import conv as TC
from satae_torch.kernels import matmul as TM
from satae_torch.models import fast_infer
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE

F32 = torch.float32


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Force interpret mode for pallas_call on the CPU test platform."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


# ---- the plan ---------------------------------------------------------------

# (M, K, N) of the float32 K1 products of the main paths on the wgmma route,
# with split_k_plan_tma's float32 plan: (tile_m, tile_n, splits,
# k_per_split) -- the mma.sync loop's splits, a cluster block holding
# ceil(splits / 16) of them
_MAIN_PATH_F32 = {
    (512, 4096, 64): (64, 64, 8, 512),  # serving projection
    (64, 4096, 64): (64, 64, 32, 128),  # AE projection fwd, dec_in dX
    (64, 4096, 128): (64, 64, 32, 128),  # calibration's projection
    (64, 4092, 64): (64, 64, 26, 160),  # ragged K: the last split shorter
    (2048, 4096, 64): (64, 64, 2, 2048),  # extraction projection
    (64, 64, 4096): (64, 64, 1, 64),  # dec_in fwd, projection dX / dW
    (512, 64, 4096): (64, 64, 1, 64),  # decoder input at chunk 512
    (4096, 64, 64): (64, 64, 1, 64),  # dec_in dW
    (512, 64, 128): (64, 64, 1, 64),  # serving fc0
    (512, 128, 64): (64, 64, 1, 128),  # serving fc1
    (64, 128, 10): (64, 64, 1, 128),  # fc2 fwd
    (7, 36, 12): (64, 64, 1, 64),  # ragged M, N and K
}


@pytest.mark.parametrize("shape", list(_MAIN_PATH_F32),
                         ids=[f"{m}x{k}x{n}" for m, k, n in _MAIN_PATH_F32])
def test_f32_tma_plan_at_main_path_shapes(shape):
    m, k, n = shape
    assert TM.split_k_plan_tma(m, n, k, dtype=F32) == _MAIN_PATH_F32[shape]


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 20000), n=st.integers(1, 5000),
       k=st.integers(1, 40000), batch=st.sampled_from([1, 11, 45]))
def test_f32_tma_plan_is_the_mma_sync_plan(m, n, k, batch):
    """The float32 wgmma route takes the mma.sync loop's splits and K
    ranges (so the two sum every output element alike); split s covers
    [s * kps, min(k, (s + 1) * kps)), every range non-empty, in order, K
    covered once, kps a multiple of the 32-deep float32 stage; a cluster
    of at most 16 blocks holds the splits, the least power of two of them
    a block that 16 blocks allow (<= MAX_SUB_F32), none empty."""
    tile_m, tile_n, splits, kps = TM.split_k_plan_tma(m, n, k, batch=batch,
                                                      dtype=F32)
    assert (tile_m, tile_n) == (64, 64)
    assert (splits, kps) == TM.split_k_plan(m, n, k, batch)[2:]
    assert kps % TM.TMA_BK_F32 == 0
    ranges = [(s * kps, min(k, (s + 1) * kps)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sub = next(u for u in (1, 2, 4, 8) if 16 * u >= splits)
    blocks = -(-splits // sub)
    assert sub <= TM.MAX_SUB_F32 and blocks <= TM.MAX_CLUSTER
    assert (blocks - 1) * sub < splits  # the last block holds a partial


# ---- the arithmetic ---------------------------------------------------------

def _satae(x, w, scale, shift, act):
    return np.asarray(KM.fused_matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(scale), jnp.asarray(shift),
                                      act))


def _emulated_tma(x, w, scale, shift, act, batch=1):
    m, k = x.shape
    n = w.shape[1]
    _, _, splits, kps = TM.split_k_plan_tma(m, n, k, batch=batch, dtype=F32)
    return emulate_k1(*(torch.from_numpy(a) for a in (x, w, scale, shift)),
                      act, plan=(splits, kps)).numpy()


# the float32 products of the main paths on the wgmma route: the cluster
# plans of K = 4096 (32 splits of 128, two a block; the serving
# projection's 8 of 512 over 8 tiles), a ragged K whose last split is
# shorter, short K in one split, and ragged M, N, K
_EMULATED_F32 = [((64, 4096, 64), "none"), ((512, 4096, 64), "relu"),
                 ((64, 4092, 64), "sigmoid"), ((64, 64, 128), "relu"),
                 ((64, 128, 10), "none"), ((7, 36, 12), "sigmoid")]


@pytest.mark.parametrize("case", _EMULATED_F32,
                         ids=[f"{m}x{k}x{n}-{a}"
                              for (m, k, n), a in _EMULATED_F32])
def test_emulated_f32_wgmma_plan_matches_satae(case):
    """The float32 wgmma kernel's arithmetic on its cluster plan against
    satae's kernel: within 1e-4 + 1e-5*|ref| (the mma.sync loop's sums on
    the same plan: the kernels agree bit for bit on the card)."""
    (m, k, n), act = case
    x, w, scale, shift = _case((m, k, n))
    ref = _satae(x, w, scale, shift, act)
    out = _emulated_tma(x, w, scale, shift, act)
    np.testing.assert_allclose(out, ref, **TOL)


# (C, M, K, N, act) of batched float32 products on the wgmma route: the
# vmap path's long-K product at C = 45 (3 splits of 1376 per config at N =
# 16, 2 of 2048 at the AE's 64) and a short-K one-split product with
# ragged M and N
_BATCHED_F32 = [(45, 8, 4096, 16, "none"), (7, 40, 64, 72, "sigmoid")]


@pytest.mark.parametrize("case", _BATCHED_F32,
                         ids=[f"C{c}_{m}x{k}x{n}"
                              for c, m, k, n, _ in _BATCHED_F32])
def test_emulated_f32_batched_plan_matches_vmapped_satae(case):
    """The kernel's arithmetic per config on the batched float32 plan
    against jax.vmap of satae's kernel (interpret mode). The 16-wide
    product runs on the mma.sync loop (k1_loader's N rule), whose sums on
    the same splits are the wgmma kernel's bit for bit: the emulation
    models both."""
    c, m, k, n, act = case
    parts = [_case((m, k, n), seed=i) for i in range(c)]
    x, w, scale, shift = (np.stack(a) for a in zip(*parts))
    ref = np.asarray(jax.vmap(
        lambda a, b, sc, sh: KM.fused_matmul(a, b, sc, sh, act))(
            *(jnp.asarray(a) for a in (x, w, scale, shift))))
    assert TM.k1_loader(torch.from_numpy(x), torch.from_numpy(w)) == (
        "cp.async" if n <= TM.F32_MMA_MAX_N else "tma")
    _, _, splits, kps = TM.split_k_plan_tma(m, n, k, batch=c, dtype=F32)
    assert (splits, kps) == {4096: (3, 1376), 64: (1, 64)}[k]
    for i in range(c):
        out = _emulated_tma(x[i], w[i], scale[i], shift[i], act, batch=c)
        np.testing.assert_allclose(out, ref[i], **TOL)


# ---- the split pass's index maps (wgmma_tile.cuh) ---------------------------

def raw_at(kmn: bool, r: int, k: int) -> int:
    """Byte offset of element (r, k) of a raw float32 stage tile as TMA
    lands it with the 128-byte swizzle (wgmma_tile.cuh::raw_at)."""
    if kmn:
        return (r >> 5) * 4096 + k * 128 + ((((r & 31) >> 2) ^ (k & 7)) << 4) \
            + (r & 3) * 4
    return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4


def tma_box_offset(kmn: bool, r: int, k: int) -> int:
    """Where TMA's 128-byte swizzle puts (r, k): 16-byte chunk c of box row
    j at chunk c ^ (j % 8); a K-major box is 64 rows r of 32 k, an MN-major
    one 32 rows k of 32 r (4 KB, two per stage)."""
    if kmn:
        box, row, col = r >> 5, k, r & 31
        return box * 4096 + row * 128 + (((col >> 2) ^ (row & 7)) << 4) \
            + (col & 3) * 4
    return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4


def kmajor_offset(r: int, k: int) -> int:
    """wgmma's K-major 128-byte-swizzled layout of a 64 x 32 float tile:
    row r of 128 bytes, 16-byte chunk k // 4 at chunk (k // 4) ^ (r % 8)
    (desc128(base + 32 j, 16, 1024) reads k8 step j)."""
    return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4


@pytest.mark.parametrize("kmn", [False, True], ids=["K-major", "MN-major"])
def test_split_b_lands_every_element_once_k_major(kmn):
    """split_b_tf32: each of the 128 threads writes 4 chunks of 4 values;
    the elements it reads from the raw tile are every (n, k) of the 64 x 32
    B once, each written where wgmma's K-major layout wants it, every
    destination slot once -- so transposing an MN-major tile into the
    K-major one and reading it back returns each element."""
    rng = np.random.default_rng(0)
    b = rng.normal(size=(64, 32)).astype(np.float32)  # (n, k)
    raw = np.zeros(2048, np.float32)  # the 8 KB raw tile, 4-byte slots
    for n in range(64):
        for k in range(32):
            raw[tma_box_offset(kmn, n, k) // 4] = b[n, k]
    assert sorted(tma_box_offset(kmn, n, k) // 4 for n in range(64)
                  for k in range(32)) == list(range(2048))
    dest = np.full(2048, np.nan, np.float32)
    seen = set()
    for t in range(128):
        for i in range(4):
            q = t + 128 * i
            if kmn:
                n, c = q & 63, q >> 6
                src = [raw_at(True, n, 4 * c + e) for e in range(4)]
                dst = n * 128 + ((c ^ (n & 7)) << 4)
                elems = [(n, 4 * c + e) for e in range(4)]
            else:
                src = [16 * q + 4 * e for e in range(4)]
                dst = 16 * q
                # a K-major raw tile is already wgmma's layout
                elems = [next((n, k) for n in range(64) for k in range(32)
                              if kmajor_offset(n, k) == 16 * q + 4 * e)
                         for e in range(4)]
            for e in range(4):
                assert np.isnan(dest[dst // 4 + e])  # written once
                dest[dst // 4 + e] = raw[src[e] // 4]
                assert dst + 4 * e == kmajor_offset(*elems[e])
                seen.add(elems[e])
    assert len(seen) == 64 * 32
    back = np.array([[dest[kmajor_offset(n, k) // 4] for k in range(32)]
                     for n in range(64)])
    np.testing.assert_array_equal(back, b)


def test_split_b_mn_major_has_no_bank_conflicts():
    """The transposing split's shared accesses: a warp's 32 reads of one e
    fall on 32 distinct banks; each quarter-warp's 16-byte writes (the
    unit one shared-memory wavefront serves) on 8 distinct chunks of 4
    banks."""
    for w in range(4):
        for i in range(4):
            qs = [32 * w + lane + 128 * i for lane in range(32)]
            for e in range(4):
                banks = {(raw_at(True, q & 63, 4 * (q >> 6) + e) // 4) % 32
                         for q in qs}
                assert len(banks) == 32
            for quarter in range(4):
                chunks = {((q & 63) * 128 + (((q >> 6) ^ ((q & 63) & 7))
                                             << 4)) // 16 % 8
                          for q in qs[8 * quarter:8 * quarter + 8]}
                assert len(chunks) == 8


@pytest.mark.parametrize("kmn", [False, True], ids=["K-major", "MN-major"])
def test_a_fragments_cover_the_tile_once(kmn):
    """load_a_tf32: thread t of the warpgroup loads a0..a3 of k8 step j at
    rows 16 (t / 32) + (t % 32) / 4 (+ 8), k 8 j + t % 4 (+ 4) -- wgmma's
    m64nNk8 TF32 A fragment, the m16n8k8 layout per warp -- and together
    the 128 threads read each element of the 64 x 32 stage once, from raw
    offsets that are a bijection onto the tile."""
    cells, offsets = [], []
    for t in range(128):
        r = 16 * (t // 32) + (t % 32) // 4
        for j in range(4):
            for e in range(4):
                rr, kk = r + 8 * (e % 2), 8 * j + t % 4 + 4 * (e // 2)
                cells.append((rr, kk))
                offsets.append(raw_at(kmn, rr, kk))
                assert raw_at(kmn, rr, kk) == tma_box_offset(kmn, rr, kk)
    assert sorted(cells) == [(r, k) for r in range(64) for k in range(32)]
    assert sorted(offsets) == list(range(0, 8192, 4))


# ---- the float32 fold and the routes of its launches -----------------------

@pytest.fixture(scope="module")
def full_width():
    """The default (full-width) encoder and MLP, random weights from a
    seed, BatchNorm stats moved off their init."""
    torch.manual_seed(0)
    cfg = TCfg.ModelConfig()
    ae, mlp = SupervisedAE(cfg, image_size=64).eval(), MLP(cfg).eval()
    for mod in (ae, mlp):
        for bn in (m for m in mod.modules() if isinstance(
                m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))):
            bn.running_mean.uniform_(-0.5, 0.5)
            bn.running_var.uniform_(0.5, 1.5)
    return ae, mlp


def test_f32_fold_is_k_major_with_bitwise_the_same_values(full_width):
    """The float32 fold keeps every weight K-major -- conv weights the HWIO
    view of a (Cout, KH, KW, Cin) buffer, linear weights (out, in) read
    with w_nk -- with bitwise the values of the (K, N) layouts it used to
    hand K1 and K2, and the conv weights' TF32 halves beside them; the bf16
    fold keeps those layouts and has no halves."""
    ae, mlp = full_width
    fe, fm = fast_infer.fold_encoder(ae.enc), fast_infer.fold_mlp(mlp)
    fe16 = fast_infer.fold_encoder(ae.enc, torch.bfloat16)
    for c, (conv, _), c16 in zip(fe.convs, ae.enc.blocks(), fe16.convs):
        assert TC.is_k_major(c.w) and not c.w.is_contiguous()
        hwio = conv.weight.detach().permute(2, 3, 1, 0).contiguous()
        assert torch.equal(c.w, hwio)
        assert torch.equal(c.w_tf32, TC.split_tf32(c.w))
        assert c16.w.is_contiguous() and c16.w_tf32 is None and torch.equal(
            c16.w, hwio.to(torch.bfloat16))
    # the projection: rows of the NHWC flatten, as the (K, N) fold had them
    c = ae.enc.blocks()[-1][0].out_channels
    w = ae.enc.proj.weight.detach()
    s = int(round((w.shape[1] // c) ** 0.5))
    kn = w.reshape(-1, c, s, s).permute(2, 3, 1, 0).reshape(s * s * c, -1)
    assert fe.proj.w_nk and fe.proj.w.is_contiguous()
    assert fe.proj.w.shape == (w.shape[0], s * s * c)
    assert torch.equal(fe.proj.w.t(), kn)
    assert not fe16.proj.w_nk and torch.equal(
        fe16.proj.w, kn.to(torch.bfloat16))
    for layer, fc in zip(fm.layers, [fc for fc, _ in mlp.hidden()]
                         + [mlp.out]):
        assert layer.w_nk and layer.w.is_contiguous()
        assert torch.equal(layer.w, fc.weight)


def test_f32_fold_serves_as_the_plain_modules(full_width):
    """encoder_infer / mlp_infer on the float32 fold (the plain kernel
    versions on the CPU) against the modules' eval forward."""
    ae, mlp = full_width
    x = torch.from_numpy(np.random.default_rng(1).random(
        (4, 64, 64, 3), dtype=np.float32))
    fe, fm = fast_infer.fold_encoder(ae.enc), fast_infer.fold_mlp(mlp)
    with torch.no_grad():
        z = fast_infer.encoder_infer(fe, x)
        torch.testing.assert_close(z, ae.enc(x), rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(fast_infer.mlp_infer(fm, z), mlp(z),
                                   rtol=1e-5, atol=1e-4)


def test_f32_serving_launches_take_the_wgmma_route(full_width):
    """Every float32 launch of a 512-image serving chunk on the fold's own
    buffers: conv0 on the staged-rows kernel, conv1-3 on the TMA im2col
    kernel, fc0 and fc1 on K1's wgmma route; the projection (8 splits of
    512) and the 10-wide head on the mma.sync loop, which --ab timed faster
    there (k1_loader's rules)."""
    ae, mlp = full_width
    fe, fm = fast_infer.fold_encoder(ae.enc), fast_infer.fold_mlp(mlp)
    h, routes = 64, []
    for c in fe.convs:
        x = _buffer((512, h, h, c.w.shape[2]), F32)
        routes.append(TC.conv_route(x, c.w, c.stride, c.padding))
        h //= 2
    assert routes == [("rows", 32)] + [("im2col", 64)] * 3
    k = fe.proj.w.shape[1]
    assert TM.k1_loader(_buffer((512, k), F32), fe.proj.w,
                        trans_b=fe.proj.w_nk) == "cp.async"
    assert [TM.k1_loader(_buffer((512, layer.w.shape[1]), F32), layer.w,
                         trans_b=layer.w_nk) for layer in fm.layers] == [
        "tma", "tma", "cp.async"]


@pytest.mark.parametrize("shape", [(3, 3, 32, 64), (3, 3, 3, 32),
                                   (1, 1, 5, 9)], ids=str)
def test_split_tf32_is_the_kernels_split(shape):
    """split_tf32 (the fold's TF32 halves of a float32 conv weight, which
    the im2col kernel reads) against the kernels' split in registers as the
    emulation models it: big = tf32_rna(v), small = tf32_rna(v - big), in
    the K-major (Cout, KH * KW * Cin) order, bit for bit."""
    rng = np.random.default_rng(3)
    w_oihw = torch.from_numpy(rng.normal(
        size=(shape[3], shape[2], shape[0], shape[1])).astype(np.float32))
    w = TC.pack_conv_weight(w_oihw)
    halves = TC.split_tf32(w)
    v = w_oihw.permute(0, 2, 3, 1).reshape(-1)
    big = tf32(v)
    assert halves.dtype == F32 and halves.shape == (2 * v.numel(),)
    assert torch.equal(halves.view(torch.int32),
                       torch.cat([big, tf32(v - big)]).view(torch.int32))


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16], ids=str)
def test_pack_conv_weight_lays_out_by_dtype(dtype):
    """pack_conv_weight picks K2's layout from the weight's dtype alone --
    K-major in float32, contiguous HWIO in bf16, the same values either way
    -- never the other dtype's layout (split_tf32 takes only the float32
    one)."""
    rng = np.random.default_rng(4)
    w_oihw = torch.from_numpy(
        rng.normal(size=(64, 32, 3, 3)).astype(np.float32)).to(dtype)
    w = TC.pack_conv_weight(w_oihw)
    hwio = w_oihw.permute(2, 3, 1, 0).contiguous()
    other = (hwio if dtype == F32
             else hwio.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0))
    assert torch.equal(w, hwio) and torch.equal(other, hwio)
    assert TC.is_k_major(w) == (dtype == F32) != w.is_contiguous()
    assert TC.is_k_major(other) == (dtype != F32) != other.is_contiguous()
    with pytest.raises(ValueError, match="split_tf32"):
        TC.split_tf32(hwio.float() if dtype == F32 else w)
