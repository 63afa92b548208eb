"""The port's config, layers, models, weight carry-over and checkpoint reader
against satae, on the same numpy-made weights and inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satae import config as JC
from satae.io.torch_export import (mlp_to_torch_state_dict as jax_mlp_sd,
                                   sae_to_torch_state_dict as jax_sae_sd)
from satae.models.decoder import decoder_apply
from satae.models.encoder import encoder_apply
from satae.models.mlp import mlp_apply, mlp_init
from satae.models.supervised_ae import supervised_ae_apply, supervised_ae_init
from satae.nn import layers as JL
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TCfg
from satae_torch.io import checkpoint, convert
from satae_torch.models.decoder import Decoder
from satae_torch.models.encoder import Encoder
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn import layers as TL

CFG = JC.ModelConfig(latent_dim=16, encoder_channels=(4, 8, 8, 16),
                     mlp_hidden=(32, 16))
TCFG = TCfg.ModelConfig(**dataclasses.asdict(CFG))
IMG = 32
CKPT = "benchmarks/full_run_hard_f32"


def numpy_trees(init, *args, seed=0, **kw):
    """satae (params, state) trees of ``init``'s shapes, drawn from numpy:
    weights uniform in +-1/sqrt(fan_in) (PyTorch's default scale, which keeps
    activations O(1)), BatchNorm leaves non-trivial (fresh ones are 1/0, which
    would hide a swapped scale/bias or mean/var). Shapes come from
    ``jax.eval_shape``, which traces without running the initialiser."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if "var" in key or "scale" in key:
            v = rng.uniform(0.5, 1.5, a.shape)
        elif "mean" in key or "bias" in key or "'b'" in key:
            v = rng.normal(0, 0.3, a.shape)
        else:
            bound = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            v = rng.uniform(-bound, bound, a.shape)
        return v.astype(np.float32)

    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args, **kw))
    return tuple(jax.tree_util.tree_map_with_path(draw, t) for t in shapes)


@pytest.fixture(scope="module")
def sae_trees():
    return numpy_trees(supervised_ae_init, CFG, image_size=IMG, seed=1)


@pytest.fixture(scope="module")
def mlp_trees():
    return numpy_trees(mlp_init, CFG, seed=2)


def _images(n=6, seed=5):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, IMG, IMG, 3)).astype(np.float32)


def test_config_defaults_match_satae():
    for name in ("DataConfig", "ModelConfig", "AETrainConfig",
                 "MLPTrainConfig", "RuntimeConfig"):
        ours = dataclasses.asdict(getattr(TCfg, name)())
        theirs = dataclasses.asdict(getattr(JC, name)())
        theirs.pop("use_pallas", None)  # the device chooses in the port
        assert ours == theirs, name
    assert TCfg.EUROSAT_CLASSES == JC.EUROSAT_CLASSES
    cfg = TCfg.PipelineConfig()
    assert cfg.compute_dtype is torch.float32
    ours = dataclasses.asdict(TCfg.throughput_config(cfg))
    theirs = dataclasses.asdict(JC.throughput_config(JC.PipelineConfig()))
    ours.pop("runtime"), theirs.pop("runtime")
    assert ours == theirs


def test_convert_equals_satae_export_bit_for_bit(sae_trees, mlp_trees):
    for ours, theirs in (
            (convert.sae_to_torch_state_dict(*sae_trees, TCFG,
                                             image_size=IMG),
             jax_sae_sd(*sae_trees, CFG, image_size=IMG)),
            (convert.mlp_to_torch_state_dict(*mlp_trees, TCFG),
             jax_mlp_sd(*mlp_trees, CFG))):
        assert list(ours) == list(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def _layer_case(kind, rng):
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 3, 5)).astype(np.float32)
    b = rng.normal(0, 0.3, 5).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if kind == "conv2d":
        ref = JL.conv2d({"w": w, "b": b}, jnp.asarray(x), stride=2, padding=1)
        out = TL.conv2d(t(x), t(w.transpose(3, 2, 0, 1)), t(b), 2, 1)
    elif kind == "conv_transpose2d":
        # satae keeps the flipped equivalent-forward kernel (kh, kw, I, O)
        ref = JL.conv2d_transpose({"w": w, "b": b}, jnp.asarray(x))
        out = TL.conv_transpose2d(
            t(x), t(w[::-1, ::-1].transpose(2, 3, 0, 1)), t(b), 2, 1, 1)
    elif kind == "batchnorm":
        p = {"scale": rng.uniform(0.5, 1.5, 3).astype(np.float32),
             "bias": rng.normal(0, 0.3, 3).astype(np.float32)}
        s = {"mean": rng.normal(0, 0.3, 3).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 3).astype(np.float32)}
        ref, _ = JL.batchnorm(p, s, jnp.asarray(x), train=False)
        out = TL.batchnorm(t(x), t(p["scale"]), t(p["bias"]), t(s["mean"]),
                           t(s["var"]))
    else:
        xl = x.reshape(2, -1)
        wl = rng.normal(0, 0.1, (xl.shape[1], 7)).astype(np.float32)
        ref = JL.linear({"w": wl, "b": b[:1].repeat(7)}, jnp.asarray(xl))
        out = TL.linear(t(xl), t(wl.T), t(b[:1].repeat(7)))
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("kind", ["conv2d", "conv_transpose2d", "batchnorm",
                                  "linear"])
def test_layer_matches_satae(kind):
    ref, out = _layer_case(kind, np.random.default_rng(7))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _loaded_sae(sae_trees):
    model = SupervisedAE(TCFG, image_size=IMG)
    sd = convert.sae_to_torch_state_dict(*sae_trees, TCFG,
                                         image_size=IMG)
    model.load_state_dict(convert.to_tensors(sd), strict=True)
    return model.eval()


def test_autoencoder_parts_match_satae_eval_forward(sae_trees):
    model = _loaded_sae(sae_trees)
    params, state = sae_trees
    x = _images()
    (xh_j, lg_j, z_j), _ = supervised_ae_apply(params, state, jnp.asarray(x),
                                               train=False, cfg=CFG)
    with torch.no_grad():
        xh, lg, z = model(torch.from_numpy(x))
        z_enc = model.enc(torch.from_numpy(x))
        xh_dec = model.dec(torch.from_numpy(np.array(z_j)))
    z_e, _ = encoder_apply(params["encoder"], state["encoder"],
                           jnp.asarray(x), train=False, cfg=CFG)
    xh_d, _ = decoder_apply(params["decoder"], state["decoder"], z_j,
                            train=False, cfg=CFG, image_size=IMG)
    for ours, ref in ((z_enc, z_e), (xh_dec, xh_d), (z, z_j), (lg, lg_j),
                      (xh, xh_j)):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_mlp_matches_satae_eval_forward(mlp_trees):
    model = MLP(TCFG)
    sd = convert.mlp_to_torch_state_dict(*mlp_trees, TCFG)
    model.load_state_dict(convert.to_tensors(sd), strict=True)
    model.eval()
    z = np.random.default_rng(8).normal(size=(9, CFG.latent_dim)).astype(
        np.float32)
    ref, _ = mlp_apply(*mlp_trees, jnp.asarray(z), train=False, cfg=CFG)
    with torch.no_grad():
        out = model(torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("module", [Encoder, Decoder, SupervisedAE, MLP])
def test_training_forward_updates_running_stats(module):
    """Train mode normalises with batch statistics and moves every
    BatchNorm's running buffers; eval mode leaves them as they are."""
    torch.manual_seed(0)
    model = module(TCFG) if module is MLP else module(TCFG, 3, IMG)
    arg = (torch.randn(4, TCFG.latent_dim) if module in (Decoder, MLP)
           else torch.rand(4, IMG, IMG, 3))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.eval()(arg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    out = model.train()(arg)
    sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))
        ).backward()
    bn_keys = [k for k in before if k.endswith("running_mean")]
    assert bn_keys
    for k in bn_keys:
        assert not torch.equal(model.state_dict()[k], before[k]), k
        nbt = k.replace("running_mean", "num_batches_tracked")
        assert int(model.state_dict()[nbt]) == 1
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("name", ["ae_global_best", "mlp_global_best"])
def test_msgpack_reader_equals_flax(name):
    from flax import serialization

    data = open(f"{CKPT}/{name}.msgpack", "rb").read()
    ours = checkpoint.unpackb(data)
    theirs = serialization.msgpack_restore(data)

    def same(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and list(a) == list(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    same(ours, theirs, name)
    params, bn_state = checkpoint.load_model(f"{CKPT}/{name}.msgpack")
    same(params, theirs["params"], name)
    same(bn_state, theirs["bn_state"], name)


def test_msgpack_reader_rejects_malformed_input():
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.unpackb(b"\x82\xa1a")
    with pytest.raises(ValueError, match="trailing"):
        checkpoint.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="ext type"):
        checkpoint.unpackb(b"\xd4\x05\x00")
