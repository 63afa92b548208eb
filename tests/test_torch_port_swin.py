"""The Swin encoder served through SatAEPipeline (satae_torch.models.swin,
fast_infer.fold_swin / swin_encoder_infer, the window-attention wrapper,
the LayerNorm wrapper's post mode), on the CPU, where every kernel runs its
plain version, held against the plain float32 reference of
tests/satlas_swin_reference.py, which is written from the layer equations
and imports nothing of the port; and the plain versions held against the
textbook formulas. The kernels themselves are held against these plain
versions on the card by tests/test_torch_port_window_attention_card.py.

The small size keeps every width's role at a few seconds: 256-px chips of
9 bands in patches of 4, so that the four stages run 64, 32, 16 and 8
tokens wide and stage 4's window is its side (no shift there); width 32,
depths (2, 2, 2, 2), heads (1, 2, 4, 8) of 32.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import satlas_swin_reference as SR
from prithvi_reference import head_init, head_logits
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as C
from satae_torch.api import SatAEPipeline
from satae_torch.kernels import launch_counts
from satae_torch.kernels.layernorm import (layer_norm_post,
                                           layer_norm_post_plain)
from satae_torch.kernels.window_attention import (window_attention,
                                                  window_attention_plain)
from satae_torch.models import fast_infer as FI
from satae_torch.models import swin as SW

SCALE = (1 / 255,) * 3 + (1 / 8160,) * 6
CFG = dict(img_size=256, patch_size=4, in_chans=9, embed_dim=32,
           depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=8,
           mlp_ratio=4.0, norm_eps=1e-5, band_scale=SCALE)
SC = C.SwinConfig(**CFG)
HEAD = [256, 16, 8, 10]


def _pipe(dtype="float32", **kw):
    pc = C.PipelineConfig(
        data=C.DataConfig(batch_size=2),
        model=C.ModelConfig(latent_dim=256, mlp_hidden=tuple(HEAD[1:-1])),
        runtime=C.RuntimeConfig(compute_dtype=dtype, **kw))
    return SatAEPipeline(pc, device="cpu", encoder=SC)


@pytest.fixture(scope="module")
def weights():
    p = SR.init_params(CFG, torch.Generator().manual_seed(11), "cpu")
    # a position bias that varies across offsets by a few logits, so that
    # the check sees its table (the init's is nearly flat)
    for k in p:
        if k.endswith("cpb_mlp.2.weight"):
            p[k] = p[k] * 8
    return p, head_init(HEAD, 12)


@pytest.fixture(scope="module")
def chips():
    """20 chips: two serving chunks of 16, the second ragged; the 8-bit
    bands and the 16-bit ones, some above the scale's clip."""
    rng = np.random.default_rng(3)
    top = np.array([255] * 3 + [16000] * 6).reshape(1, 9, 1, 1)
    level = rng.uniform(0.05, 0.9, (20, 9, 1, 1)) * top
    x = level + rng.normal(0, 0.05, (20, 9, 256, 256)) * top
    return np.clip(x, 0, top).astype(np.int16)


@pytest.fixture(scope="module")
def reference(weights, chips):
    p, hp = weights
    z = SR.latents(p, CFG, torch.from_numpy(chips))
    return z.numpy(), head_logits(hp, z).numpy()


# float32: the plain kernels compute what the reference does, in another
# order of sums (read: 1e-7); bf16: every activation is rounded to 8
# significant bits (2^-9 relative) at each of the ~8 roundings of a block,
# eight blocks and three merges, and the mean over 64 tokens averages them:
# a chip's latent within 2 % of the reference's (read: 0.3-0.7 %), its
# logits within 5 % of the logits' spread
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_path_matches_the_reference(weights, chips, reference,
                                           dtype):
    z_ref, lg_ref = reference
    pipe = _pipe(dtype).load_torch(*weights)
    before = launch_counts()
    z = pipe.encode(chips)
    assert launch_counts() == before  # the plain versions: no launch
    rel = np.linalg.norm(z - z_ref, axis=1) / np.linalg.norm(z_ref, axis=1)
    # the chips' latents differ well above the bf16 tolerance (median
    # pairwise distance 0.12 of a latent's norm), so it tells them apart
    pair = np.linalg.norm(z_ref[:, None] - z_ref[None], axis=-1) \
        / np.linalg.norm(z_ref, axis=1)[:, None]
    assert np.median(pair[~np.eye(len(z_ref), dtype=bool)]) \
        > 5 * TOL["bfloat16"][0]
    assert rel.max() < TOL[dtype][0], rel.max()
    proba = pipe.predict_proba(chips)
    lg = np.log(proba)
    lg_r = lg_ref - np.log(np.exp(lg_ref).sum(1, keepdims=True))
    spread = lg_r.max() - lg_r.min()
    assert np.abs(lg - lg_r).max() < TOL[dtype][1] * spread
    np.testing.assert_array_equal(pipe.predict(chips), proba.argmax(1))


def _textbook(qkv, chips, side, heads, shift, bias, scale, window=8):
    """Each token's output from its coordinates alone: its position in the
    rolled grid, the window there, every key of that window with its
    offset's bias and -100 where the two tokens' regions of the rolled
    grid differ, in float64."""
    c = qkv.shape[1] // 3
    d = c // heads
    x = qkv.double().view(chips, side, side, 3, heads, d)
    out = torch.zeros(chips, side, side, heads, d, dtype=torch.float64)

    def region(v):
        return 0 if v < side - window else (1 if v < side - shift else 2)

    for y in range(side):
        for xx in range(side):
            ry, rx = (y - shift) % side, (xx - shift) % side
            wy, wx = ry // window, rx // window
            keys = [(wy * window + a, wx * window + b)
                    for a in range(window) for b in range(window)]
            i = (ry % window) * window + rx % window
            oy = torch.tensor([(ky + shift) % side for ky, _ in keys])
            ox = torch.tensor([(kx + shift) % side for _, kx in keys])
            cross = torch.tensor([
                float(shift > 0 and (region(ry), region(rx))
                      != (region(ky), region(kx))) for ky, kx in keys],
                dtype=torch.float64)
            q = x[:, y, xx, 0]  # (chips, heads, d)
            k, v = x[:, oy, ox, 1], x[:, oy, ox, 2]  # (chips, 64, heads, d)
            cos = (q[:, None] * k).sum(-1) / (q.norm(dim=-1)[:, None]
                                              * k.norm(dim=-1))
            s = cos * scale.double() + bias[:, i].double().t() \
                - 100.0 * cross[:, None]
            p = torch.softmax(s, dim=1)  # over the 64 keys
            out[:, y, xx] = (p[..., None] * v).sum(1)
    return out.reshape(chips * side * side, c)


@pytest.mark.parametrize("side,shift", [(24, 4), (24, 2), (16, 4), (8, 0),
                                        (16, 0)])
def test_window_attention_plain_is_the_textbook_formula(side, shift):
    g = torch.Generator().manual_seed(side * 10 + shift)
    heads, chips = 2, 2
    qkv = torch.randn(chips * side * side, 3 * heads * 4, generator=g)
    bias = 16 * torch.sigmoid(torch.randn(heads, 64, 64, generator=g))
    scale = torch.tensor([100.0, 12.5])
    got = window_attention(qkv, chips, side, heads, 8, shift, bias, scale)
    want = _textbook(qkv, chips, side, heads, shift, bias, scale)
    assert got.dtype == torch.float32
    # float32 scores at a scale of 100 carry ~1e-5 of rounding into the
    # softmax; float64 here
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    # bf16 operands: the same formula on their values, rounded once
    qb = qkv.to(torch.bfloat16)
    got = window_attention_plain(qb, chips, side, heads, 8, shift, bias,
                                 scale)
    want = _textbook(qb.float(), chips, side, heads, shift, bias, scale)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.double(), want, rtol=2 ** -8, atol=1e-4)


def test_shift_masks_only_the_seam_windows():
    """At side 16 with shift 4 the bottom-right window holds tokens of four
    regions: a query attends to its own region's keys only (every other
    weight below e^-100 of them); the top-left window holds one region."""
    side, heads = 16, 1
    qkv = torch.zeros(side * side, 96)
    qkv[:, 64:] = torch.arange(side * side, dtype=torch.float32)[:, None]
    qkv[:, :64] = 1.0  # every score equal: softmax is the mask's mean
    bias = torch.zeros(1, 64, 64)
    out = window_attention_plain(qkv, 1, side, heads, 8, 4, bias,
                                 torch.ones(1))[:, 0].view(side, side)
    # the query at original (0, 0) sits at rolled (12, 12): region (2, 2),
    # whose keys are originals (0..3, 0..3): the mean of their indices
    want = torch.tensor([[r * side + c for c in range(4)]
                         for r in range(4)], dtype=torch.float32).mean()
    assert float(out[0, 0]) == pytest.approx(float(want))
    # original (4, 4) sits at rolled (0, 0), a window of one region: the
    # mean over the originals (4..11, 4..11)
    want = torch.tensor([[r * side + c for c in range(4, 12)]
                         for r in range(4, 12)], dtype=torch.float32).mean()
    assert float(out[4, 4]) == pytest.approx(float(want))


def test_fold_clamps_the_logit_scale_and_zeroes_the_k_bias(weights):
    p = dict(weights[0])
    pre = "features.1.0.attn."
    p[pre + "logit_scale"] = torch.tensor([[[math.log(100.0) + 0.7]]])
    enc = SW.SwinEncoder(SC)
    enc.load_state_dict(p, strict=True)
    fs = FI.fold_swin(enc, SC, torch.float32)
    blk = fs.stages[0][0]
    assert float(blk.scale[0]) == pytest.approx(100.0)
    d = SC.widths[0]
    assert torch.equal(blk.qkv.shift[d:2 * d], torch.zeros(d))
    torch.testing.assert_close(blk.qkv.shift[:d], p[pre + "qkv.bias"][:d])
    # the folded bias is 16 sigmoid(cpb_mlp(table)) at each pair's offset
    hid = torch.relu(p[pre + "relative_coords_table"].reshape(-1, 2)
                     @ p[pre + "cpb_mlp.0.weight"].t()
                     + p[pre + "cpb_mlp.0.bias"])
    table = hid @ p[pre + "cpb_mlp.2.weight"].t()
    for (yi, xi), (yj, xj) in [((0, 0), (7, 7)), ((3, 5), (2, 1)),
                               ((7, 0), (0, 7))]:
        i, j = yi * 8 + xi, yj * 8 + xj
        off = (yi - yj + 7) * 15 + (xi - xj + 7)
        assert float(blk.bias[0, i, j]) == pytest.approx(
            16 * float(torch.sigmoid(table[off, 0])), rel=1e-6)
    assert [b.shift for st in fs.stages for b in st] == [0, 4, 0, 4, 0, 4,
                                                         0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_post_plain(dtype):
    g = torch.Generator().manual_seed(4)
    h = (torch.randn(37, 64, generator=g) * 3).to(dtype)
    x = (torch.randn(37, 64, generator=g) + 0.5).to(dtype)
    w = torch.randn(64, generator=g) * 0.1 + 1
    b = torch.randn(64, generator=g) * 0.1
    want = (h.float() + F.layer_norm(x.float(), (64,), w, b, 1e-5)).to(dtype)
    got = h.clone()
    assert layer_norm_post(got, x, w, b, 1e-5) is got
    assert torch.equal(got, layer_norm_post_plain(h.clone(), x, w, b, 1e-5))
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 0.07)
    with pytest.raises(ValueError, match="residual"):
        layer_norm_post(h[:3].clone(), x, w, b, 1e-5)


def _torchvision_merge(x):
    """torchvision's ``_patch_merging_pad`` on even sides."""
    x0 = x[..., 0::2, 0::2, :]
    x1 = x[..., 1::2, 0::2, :]
    x2 = x[..., 0::2, 1::2, :]
    x3 = x[..., 1::2, 1::2, :]
    return torch.cat([x0, x1, x2, x3], -1)


def test_merge_order_is_torchvisions():
    x = torch.randn(2, 6, 10, 5)
    assert torch.equal(SW.merge_patches(x), _torchvision_merge(x))


def test_load_torch_round_trips_torchvisions_keys(weights, chips):
    p, hp = weights
    assert set(p) == set(SW.SwinEncoder(SC).state_dict())
    # a wrapper's prefix, torchvision's final norm and head, and a
    # wrapper's other heads are left out
    sd = {"backbone.backbone." + k: v for k, v in p.items()}
    sd.update({"backbone.backbone.norm.weight": torch.ones(256),
               "backbone.backbone.head.weight": torch.ones(10, 256),
               "intermediates.0.weight": torch.ones(3)})
    pipe = _pipe().load_torch(sd, hp)
    for k, v in p.items():
        assert torch.equal(pipe.frozen.state_dict()[k], v), k
    np.testing.assert_array_equal(_pipe().load_torch(p, hp).encode(chips[:3]),
                                  pipe.encode(chips[:3]))
    # the module's own buffers are torchvision's
    enc = SW.SwinEncoder(SC)
    pre = "features.3.1.attn."
    assert torch.equal(enc.state_dict()[pre + "relative_coords_table"],
                       p[pre + "relative_coords_table"])
    assert torch.equal(enc.state_dict()[pre + "relative_position_index"],
                       p[pre + "relative_position_index"])
    del sd["backbone.backbone.features.7.1.mlp.3.bias"]
    with pytest.raises(RuntimeError, match="mlp.3.bias"):
        _pipe().load_torch(sd)


def test_module_forward_is_the_reference(weights, chips):
    """The float32 module under torchvision's keys, run as torchvision's
    code runs (rolls and window copies), is the reference."""
    enc = SW.SwinEncoder(SC)
    enc.load_state_dict(weights[0], strict=True)
    x = torch.from_numpy(chips[:2]).float() \
        * torch.tensor(SCALE).view(1, 9, 1, 1)
    with torch.no_grad():
        z = enc.latent(x.clamp(0, 1))
    torch.testing.assert_close(
        z, SR.latents(weights[0], CFG, torch.from_numpy(chips[:2])),
        rtol=1e-5, atol=1e-5)


def test_training_and_the_autoencoders_formats_refuse_the_swin(weights):
    pipe = _pipe().load_torch(*weights)
    for call in (lambda: pipe.fit(), lambda: pipe.decode(np.zeros((1, 256))),
                 lambda: pipe.save("/nonexistent"),
                 lambda: pipe.export_torch("/nonexistent"),
                 lambda: pipe.load("/nonexistent"),
                 lambda: pipe.reconstruct(np.zeros((1, 9, 256, 256),
                                                   np.int16))):
        with pytest.raises(NotImplementedError, match="Swin encoder"):
            call()


def test_input_contract(weights, chips):
    pipe = _pipe().load_torch(*weights)
    assert pipe.predict(chips[:3]).shape == (3,)
    assert pipe.predict(chips[:0]).shape == (0,)
    with pytest.raises(TypeError, match="int16"):
        pipe.predict(chips[:3].astype(np.uint16))
    with pytest.raises(TypeError, match="int16"):
        pipe.predict(chips[:3].astype(np.float32) / 8160)
    with pytest.raises(ValueError, match="chips must be"):
        pipe.predict(chips[:3, :8])  # 8 bands of 9
    with pytest.raises(ValueError, match="chips must be"):
        pipe.predict(chips[0])


def test_configs_are_checked():
    s = C.SATLAS_SWINV2B_S2MS
    assert s.sides == (128, 64, 32, 16) and s.widths == (128, 256, 512, 1024)
    assert s.latent_dim == 1024 and s.chip_shape == (9, 512, 512)
    assert [s.shift(i, j) for i in range(4) for j in range(2)] == [0, 4] * 4
    assert SC.shift(3, 1) == 0  # stage 4's side is its window
    with pytest.raises(ValueError, match="multiple of the window"):
        C.SwinConfig(img_size=200)  # stage 1 is 50 tokens wide
    with pytest.raises(ValueError, match="multiple of the window"):
        C.SwinConfig(img_size=192)  # stage 4 is 6 wide
    with pytest.raises(ValueError, match="heads"):
        C.SwinConfig(num_heads=(3, 8, 16, 32))
    with pytest.raises(ValueError, match="band_scale"):
        C.SwinConfig(band_scale=(1.0,) * 3)
    with pytest.raises(ValueError, match="one entry a stage"):
        C.SwinConfig(depths=(2, 2))
    pc = C.PipelineConfig(model=C.ModelConfig(latent_dim=32))
    with pytest.raises(ValueError, match="latent_dim"):
        SatAEPipeline(pc, device="cpu", encoder=SC)
    pc = C.PipelineConfig(model=C.ModelConfig(latent_dim=256),
                          runtime=C.RuntimeConfig(n_devices=2))
    with pytest.raises(ValueError, match="one device"):
        SatAEPipeline(pc, device="cpu", encoder=SC)
    with pytest.raises(TypeError, match="encoder must be"):
        SatAEPipeline(C.PipelineConfig(), device="cpu",
                      encoder=C.ModelConfig())


def test_window_attention_refuses_bad_arguments():
    qkv = torch.zeros(2 * 16 * 16, 96)
    bias, scale = torch.zeros(1, 64, 64), torch.ones(1)
    with pytest.raises(ValueError, match="not"):
        window_attention(qkv, 3, 16, 1, 8, 0, bias, scale)
    with pytest.raises(ValueError, match="shift"):
        window_attention(qkv, 2, 16, 1, 8, 8, bias, scale)
    with pytest.raises(ValueError, match="shift"):
        window_attention(qkv[:64], 1, 8, 1, 8, 4, bias, scale)
    with pytest.raises(ValueError, match="float32"):
        window_attention(qkv, 2, 16, 1, 8, 0, bias.double(), scale)
