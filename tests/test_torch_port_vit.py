"""The ViT encoder served through SatAEPipeline (satae_torch.models.vit,
fast_infer.fold_vit / vit_encoder_infer, the attention and LayerNorm
wrappers, K1's GELU), on the CPU, where every kernel runs its plain
version, held against the plain float32 reference of
tests/prithvi_reference.py, which is written from the layer equations and
imports nothing of the port. The kernels themselves are held against these
plain versions on the card by chip_smoke.py --vit.

The small size keeps every width's role (patches of 8 on 32-px chips, 2
frames, 6 bands, width 128, 2 heads of 64, depth 2) at a few seconds.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import prithvi_reference as PR
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as C
from satae_torch.api import SatAEPipeline
from satae_torch.kernels import launch_counts
from satae_torch.kernels.attention import attention, attention_plain
from satae_torch.kernels.layernorm import layer_norm, layer_norm_plain
from satae_torch.kernels.matmul import fused_matmul, fused_matmul_plain
from satae_torch.models import vit as V

CFG = dict(img_size=32, patch_size=8, num_frames=2, tubelet_size=1,
           in_chans=6, embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0,
           norm_eps=1e-6)
MEAN = (775.0, 1081.0, 1229.0, 2497.0, 2204.0, 1611.0)
STD = (1282.0, 1270.0, 1399.0, 1368.0, 1292.0, 1155.0)
VC = C.ViTConfig(**CFG, band_mean=MEAN, band_std=STD)
HEAD = [128, 16, 8, 10]


def _pipe(dtype="float32"):
    pc = C.PipelineConfig(
        model=C.ModelConfig(latent_dim=128, mlp_hidden=tuple(HEAD[1:-1])),
        runtime=C.RuntimeConfig(compute_dtype=dtype))
    return SatAEPipeline(pc, device="cpu", encoder=VC)


@pytest.fixture(scope="module")
def weights():
    return PR.init_params(CFG, 11), PR.head_init(HEAD, 12)


@pytest.fixture(scope="module")
def chips():
    """70 chips: two serving chunks of 64, the second ragged."""
    rng = np.random.default_rng(3)
    level = rng.uniform(300, 6000, (70, 6, 1, 1, 1))
    return np.clip(level + rng.normal(0, 700, (70, 6, 2, 32, 32)), 0,
                   10000).astype(np.int16)


@pytest.fixture(scope="module")
def reference(weights, chips):
    p, hp = weights
    z = PR.latents(p, CFG, torch.from_numpy(chips), MEAN, STD)
    return z.numpy(), PR.head_logits(hp, z).numpy()


# float32: the plain kernels compute what the reference does, in another
# order of sums; bf16: every activation is rounded to 8 significant bits
# (2^-9 relative) at each of the ~10 roundings of a block, two blocks, and
# the mean over 32 patch tokens averages them: a chip's latent within 2 %
# of the reference's (read: 0.3 %), its logits within 5 % of the logits'
# spread
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_path_matches_the_reference(weights, chips, reference,
                                           dtype):
    p, hp = weights
    z_ref, lg_ref = reference
    pipe = _pipe(dtype).load_torch(p, hp)
    before = launch_counts()
    z = pipe.encode(chips)
    proba = pipe.predict_proba(chips)
    preds = pipe.predict(chips)
    assert launch_counts() == before  # the plain versions: no launch
    z_tol, lg_tol = TOL[dtype]
    rel = np.linalg.norm(z - z_ref, axis=1) / np.linalg.norm(z_ref, axis=1)
    assert z.shape == (70, 128) and z.dtype == np.float32
    assert rel.max() < z_tol, rel.max()
    # the probabilities' logits, up to the softmax's per-chip constant
    lg = np.log(proba)
    lg = lg - lg.mean(1, keepdims=True)
    ref = lg_ref - lg_ref.mean(1, keepdims=True)
    spread = ref.std()
    assert np.abs(lg - ref).max() < lg_tol * spread
    # a chip whose best two reference logits lie further apart than twice
    # that bound is served the reference's class
    sure = np.sort(lg_ref, 1)[:, -1] - np.sort(lg_ref, 1)[:, -2] \
        > 2 * lg_tol * spread
    assert sure.sum() >= 20
    np.testing.assert_array_equal(preds[sure], lg_ref.argmax(1)[sure])


def test_module_forward_is_the_reference(weights, chips, reference):
    enc = V.ViTEncoder(VC)
    enc.load_state_dict(weights[0])
    x = torch.from_numpy(chips).float()
    x = (x - torch.tensor(MEAN).view(1, 6, 1, 1, 1)) \
        / torch.tensor(STD).view(1, 6, 1, 1, 1)
    with torch.no_grad():
        z = enc.latent(x).numpy()
    np.testing.assert_allclose(z, reference[0], rtol=1e-5, atol=1e-5)


def test_position_table_is_the_references():
    table = V.sincos_pos_embed_3d(128, (2, 4, 4))
    torch.testing.assert_close(table, PR.pos_table(CFG), rtol=0, atol=1e-7)
    # Prithvi's widths: 589 rows, the frame features 192 of 768
    big = V.sincos_pos_embed_3d(768, (3, 14, 14))
    assert big.shape == (589, 768) and bool((big[0] == 0).all())
    assert torch.equal(big[1:197, 576:], big[1, 576:].expand(196, 192))


@pytest.mark.parametrize("act", ["gelu"])
def test_gelu_epilogue_and_its_derivative(act):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(33, 24, generator=g)
    w = torch.randn(24, 40, generator=g) / 5
    scale = torch.rand(40, generator=g) + 0.5
    shift = torch.randn(40, generator=g)
    y = fused_matmul_plain(x, w, scale, shift, act)
    torch.testing.assert_close(y, F.gelu((x @ w) * scale + shift),
                               rtol=1e-6, atol=1e-6)
    ins = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
    out = fused_matmul(*ins, act)
    gy = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, ins, gy)
    ref_ins = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
    ref = F.gelu((ref_ins[0] @ ref_ins[1]) * ref_ins[2] + ref_ins[3])
    want = torch.autograd.grad(ref, ref_ins, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # an (N, K) weight read in place, as nn.Linear stores it
    ins_nk = [ins[0].detach().requires_grad_(True),
              w.t().contiguous().requires_grad_(True), None, shift]
    out = fused_matmul(ins_nk[0], ins_nk[1], None, ins_nk[3], act,
                       w_nk=True)
    dx, dw = torch.autograd.grad(out, ins_nk[:2], gy)
    ref_x = x.clone().requires_grad_(True)
    ref_w = w.clone().requires_grad_(True)
    rx, rw = torch.autograd.grad(F.gelu(ref_x @ ref_w + shift),
                                 [ref_x, ref_w], gy)
    torch.testing.assert_close(dx, rx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, rw.t(), rtol=1e-5, atol=1e-5)


def _textbook_attention(qkv, chips, heads):
    L, d = qkv.shape[0] // chips, qkv.shape[1] // (3 * heads)
    out = torch.empty(chips * L, heads * d, dtype=torch.float64)
    x = qkv.double()
    for c in range(chips):
        rows = x[c * L:(c + 1) * L]
        for h in range(heads):
            q = rows[:, h * d:(h + 1) * d]
            k = rows[:, heads * d + h * d:heads * d + (h + 1) * d]
            v = rows[:, 2 * heads * d + h * d:2 * heads * d + (h + 1) * d]
            s = q @ k.t() / math.sqrt(d)
            e = torch.exp(s - s.max(1, keepdim=True).values)
            out[c * L:(c + 1) * L, h * d:(h + 1) * d] = \
                (e / e.sum(1, keepdim=True)) @ v
    return out


@pytest.mark.parametrize("tokens", [1, 65, 129, 589])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_plain_is_the_textbook_formula_at_589_tokens(dtype,
                                                               tokens):
    """Two chips of 589 tokens (the kernel's last key tile of 128 holds 77),
    and at the edges the kernel's tiles meet: one token, 65 and 129 (one key
    past a tile of 64 and of 128); two heads of 64: the plain version is the
    formula in float32, rounded once."""
    g = torch.Generator().manual_seed(5)
    qkv = (torch.randn(2 * tokens, 3 * 2 * 64, generator=g) * 1.5).to(dtype)
    got = attention(qkv, 2, 2)
    assert got.dtype == dtype and got.shape == (2 * tokens, 128)
    assert torch.equal(got, attention_plain(qkv, 2, 2))
    want = _textbook_attention(qkv, 2, 2)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(got.double(), want, rtol=tol, atol=tol)
    with pytest.raises(ValueError):
        attention(qkv[:-1], 2, 2)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_plain_is_the_textbook_formula(dtype, residual):
    g = torch.Generator().manual_seed(6)
    x = (torch.randn(2 * 589, 768, generator=g) * 3 + 1).to(dtype)
    r = torch.randn(2 * 589, 768, generator=g).to(dtype) if residual \
        else None
    w = torch.rand(768, generator=g) + 0.5
    b = torch.randn(768, generator=g)
    x0 = x.clone()
    h, y = layer_norm(x, w, b, 1e-6, r)
    want_h = (x0.float() + r.float()).to(dtype) if residual else x0
    assert h is x and torch.equal(x, want_h)  # the sum written in place
    hd = want_h.double()
    mean = hd.mean(1, keepdim=True)
    var = ((hd - mean) ** 2).mean(1, keepdim=True)
    want = (hd - mean) / torch.sqrt(var + 1e-6) * w.double() + b.double()
    tol = 2e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y.double(), want, rtol=tol, atol=tol)
    assert y.dtype == dtype
    x1 = x0.clone()
    torch.testing.assert_close(layer_norm_plain(x1, w, b, 1e-6, r)[1], y,
                               rtol=0, atol=0)


def test_state_dict_round_trip_through_load_torch(tmp_path, weights,
                                                  chips):
    """The source's keys, a full MAE checkpoint's decoder and mask token
    left out, a file or the dict itself; a missing key refused."""
    enc = V.init_mae_(V.ViTEncoder(VC), torch.Generator().manual_seed(7))
    sd = enc.state_dict()
    assert set(sd) == {name for name, _ in PR.shapes(CFG)}
    full = dict(sd, mask_token=torch.zeros(1, 1, 64),
                **{"decoder_embed.weight": torch.zeros(64, 128)})
    torch.save(full, tmp_path / "mae.pt")
    torch.save(weights[1], tmp_path / "head.pt")
    pipe = _pipe().load_torch(str(tmp_path / "mae.pt"),
                              str(tmp_path / "head.pt"))
    for k, v in sd.items():
        assert torch.equal(pipe.frozen.state_dict()[k], v), k
    x = torch.from_numpy(chips[:5]).float()
    x = (x - torch.tensor(MEAN).view(1, 6, 1, 1, 1)) \
        / torch.tensor(STD).view(1, 6, 1, 1, 1)
    with torch.no_grad():
        np.testing.assert_allclose(pipe.encode(chips[:5]),
                                   enc.latent(x).numpy(), rtol=1e-5,
                                   atol=1e-5)
    again = _pipe().load_torch(sd, weights[1])
    np.testing.assert_array_equal(again.encode(chips[:5]),
                                  pipe.encode(chips[:5]))
    del sd["blocks.1.mlp.fc2.bias"]
    with pytest.raises(RuntimeError, match="fc2.bias"):
        _pipe().load_torch(sd)


def test_training_and_the_autoencoders_formats_refuse_the_vit(weights):
    pipe = _pipe().load_torch(*weights)
    for call in (lambda: pipe.fit(), lambda: pipe.decode(np.zeros((1, 128))),
                 lambda: pipe.save("/nonexistent"),
                 lambda: pipe.export_torch("/nonexistent"),
                 lambda: pipe.load("/nonexistent")):
        with pytest.raises(NotImplementedError, match="ViT encoder"):
            call()


def test_input_contract(weights, chips):
    pipe = _pipe().load_torch(*weights)
    assert pipe.predict(chips[:3]).shape == (3,)
    assert pipe.predict(chips[:0]).shape == (0,)
    with pytest.raises(TypeError, match="int16"):
        pipe.predict(chips[:3].astype(np.uint8))
    with pytest.raises(TypeError, match="int16"):
        pipe.predict(chips[:3].astype(np.float32) / 10000)
    with pytest.raises(ValueError, match="chips must be"):
        pipe.predict(chips[:3, :, :1])  # one frame of two
    with pytest.raises(ValueError, match="chips must be"):
        pipe.predict(chips[0])


def test_configs_are_checked():
    assert C.PRITHVI_EO1_100M.num_patches == 588
    assert C.PRITHVI_EO1_100M.mlp_dim == 3072
    assert C.PRITHVI_EO1_100M.chip_shape == (6, 3, 224, 224)
    with pytest.raises(ValueError):
        C.ViTConfig(img_size=30, patch_size=8)
    with pytest.raises(ValueError):
        C.ViTConfig(band_mean=(0.0,) * 5)
    pc = C.PipelineConfig(model=C.ModelConfig(latent_dim=64))
    with pytest.raises(ValueError, match="latent_dim"):
        SatAEPipeline(pc, device="cpu", encoder=VC)
    pc = C.PipelineConfig(model=C.ModelConfig(latent_dim=128),
                          runtime=C.RuntimeConfig(n_devices=2))
    with pytest.raises(ValueError, match="one device"):
        SatAEPipeline(pc, device="cpu", encoder=VC)
