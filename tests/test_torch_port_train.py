"""The port's training modules against satae's, at a tiny config (channels
(4, 8), latent 8, head 16, MLP (16, 8), 16x16 images, batch 8).

Every random draw of satae's steps (the augmentation's flip, offsets and
noise, the MLP's dropout mask) is drawn here with ``jax.random`` from the key
satae's step uses and handed to the port's step, whose own streams are torch
generators. Weights start from satae's initialisers and reach the port
through satae_torch/io/convert.py; after training the port's state_dict is
compared with satae's trees carried over the same way. On the CPU the port's
linear layers run K1's plain versions (forward and backward).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satae.nn.init as jax_init
from satae import config as JC
from satae.data.augment import augment_train_batch as jax_augment
from satae.data.augment import flip_crop_select
from satae.data.pipeline import ArrayDataset as JaxArrayDataset
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from satae.nn import layers as JL
from satae.train import fast_loop as jax_fast_loop
from satae.train import hbm as jax_hbm
from satae.train import losses as JLoss
from satae.train.extract import extract_features as jax_extract
from satae.train.optim import adam_init as jax_adam_init
from satae.train.optim import adam_update as jax_adam_update
from satae.train.steps import (ae_eval_step_body, ae_train_step_body,
                               make_mlp_eval_step, make_mlp_predict,
                               make_mlp_train_step)
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.data.augment import augment_train_batch, flip_crop
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.io.convert import (mlp_to_torch_state_dict,
                                    sae_to_torch_state_dict, to_tensors)
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn import init as TInit
from satae_torch.nn import layers as TL
from satae_torch.train import fast_loop, hbm, losses, optim
from satae_torch.train.extract import extract_features
from satae_torch.train.steps import (ae_eval_step, ae_train_step,
                                     mlp_eval_step, mlp_predict,
                                     mlp_train_step)

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, B = 16, 8
JDATA = JC.DataConfig(image_size=IMG, batch_size=B)
TDATA = TC.DataConfig(image_size=IMG, batch_size=B)
ALPHA, AE_LR, MLP_LR, WD = 35.0, 5e-3, 1e-3, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _u8(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3),
                                                dtype=np.uint8)


def _satae_aug_draws(key, n):
    """The flip, offsets and noise satae's augment_train_batch draws from
    ``key`` (augment.py:83-93)."""
    kf, kc, kn = jax.random.split(key, 3)
    return dict(flip=_t(jax.random.bernoulli(kf, 0.5, (n, 1))),
                offsets=_t(jax.random.randint(kc, (n, 2), 0,
                                              2 * JDATA.crop_padding + 1)),
                noise=_t(jax.random.normal(kn, (n, IMG, IMG, 3))))


class _PreBNBiases:
    """The biases of the layers that feed a train-mode BatchNorm (the
    encoder convs, the decoder's first transposed convs, the MLP's hidden
    linears). BatchNorm subtracts the batch mean, so their exact gradient is
    zero and what each framework computes is rounding noise; Adam divides
    it by its own magnitude and moves these biases by up to lr per step in
    the noise's sign. Their values are not held against satae's. They do
    reach the BatchNorm's running mean, 0.1 of the bias per step; ``record``
    accumulates that share (before each step) so that the running mean of
    the layer's bias-free output can be held to the tolerance."""

    def __init__(self, model, momentum):
        names = {m: n for n, m in model.named_modules()}
        pairs = (model.hidden() if isinstance(model, MLP) else
                 model.enc.blocks() + [(c, bn) for c, bn in model.dec.blocks()
                                       if bn is not None])
        self.pairs = [(f"{names[layer]}.bias", names[bn])
                      for layer, bn in pairs]
        self.momentum = momentum
        self.share = {bn: 0.0 for _, bn in self.pairs}

    def record(self, sd):
        for bias, bn in self.pairs:
            self.share[bn] = ((1 - self.momentum) * self.share[bn]
                              + self.momentum * np.asarray(sd[bias]))


def _assert_state_close(model, ref_sd, ours_pre, ref_pre, tol=1e-4):
    ours = model.state_dict()
    skip = {bias for bias, _ in ours_pre.pairs}
    for k, v in ref_sd.items():
        if k.endswith("num_batches_tracked") or k in skip:
            continue
        a, b = ours[k].numpy(), np.asarray(v)
        bn = k.removesuffix(".running_mean")
        if bn in ours_pre.share:
            a, b = a - ours_pre.share[bn], b - ref_pre.share[bn]
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("shape", [(8, 4, 4, 5), (16, 6)], ids=str)
def test_train_batchnorm_matches_satae(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    c = shape[-1]
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.3, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.3, c).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    ref, new_s = JL.batchnorm(p, s, jnp.asarray(x), train=True)
    mean, var = _t(s["mean"]), _t(s["var"])
    out = TL.batchnorm_train(_t(x), _t(p["scale"]), _t(p["bias"]), mean, var)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(new_s["mean"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(new_s["var"]),
                               atol=1e-5, rtol=1e-5)


def test_dropout_with_satae_mask():
    key = jax.random.PRNGKey(4)
    x = np.random.default_rng(1).normal(size=(B, 16)).astype(np.float32)
    ref = JL.dropout(key, jnp.asarray(x), 0.3, True)
    mask = _t(jax.random.bernoulli(key, 0.7, x.shape))
    np.testing.assert_allclose(TL.dropout(_t(x), 0.3, mask=mask).numpy(),
                               np.asarray(ref), rtol=1e-6, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    drawn = TL.dropout(torch.ones(4000), 0.3, generator=g)
    assert set(np.unique(drawn.numpy())) == {0.0, np.float32(1 / 0.7)}
    assert abs(float((drawn == 0).float().mean()) - 0.3) < 0.03


def test_flip_crop_bit_exact():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32)
    flip = rng.integers(0, 2, (B, 1)).astype(bool)
    offsets = rng.integers(0, 9, (B, 2)).astype(np.int32)
    ref = flip_crop_select(jnp.asarray(x), jnp.asarray(flip),
                           jnp.asarray(offsets), 4)
    out = flip_crop(_t(x), _t(flip), _t(offsets), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_augmentation_with_satae_draws():
    key = jax.random.PRNGKey(7)
    imgs = _u8(B, seed=3)
    ref = jax_augment(key, jnp.asarray(imgs))
    out = augment_train_batch(_t(imgs), **_satae_aug_draws(key, B))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    g = torch.Generator().manual_seed(0)
    drawn = augment_train_batch(_t(imgs), generator=g)
    assert drawn.shape == imgs.shape and drawn.dtype == torch.float32


def test_losses_match_satae():
    rng = np.random.default_rng(5)
    x_hat, x = (rng.uniform(0, 1, (B, IMG, IMG, 3)).astype(np.float32)
                for _ in "ab")
    logits = rng.normal(0, 3, (B, 10)).astype(np.float32)
    labels = rng.integers(0, 10, B)
    ref = JLoss.joint_ae_loss(jnp.asarray(x_hat), jnp.asarray(logits),
                              jnp.asarray(x), jnp.asarray(labels), ALPHA)
    out = losses.joint_ae_loss(_t(x_hat), _t(logits), _t(x), _t(labels),
                               ALPHA)
    for a, b in zip(out, ref):  # float32 sums of 6,144 terms, other order
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6)
    assert float(losses.accuracy(_t(logits), _t(labels))) == float(
        JLoss.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_adam_with_weight_decay_matches_satae():
    rng = np.random.default_rng(6)
    shapes = [(5, 3), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ours = [_t(p) for p in params]
    state_j, state_t = jax_adam_init(params), optim.adam_init(ours)
    theirs = [jnp.asarray(p) for p in params]
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        theirs, state_j = jax_adam_update(theirs, [jnp.asarray(g)
                                                   for g in grads],
                                          state_j, jnp.float32(1e-2), 1e-2)
        optim.adam_update(ours, [_t(g) for g in grads], state_t, 1e-2, 1e-2)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert state_t.step == int(state_j["step"]) == 5


def test_ae_train_steps_match_satae():
    key = jax.random.PRNGKey(0)
    params, state = supervised_ae_init(key, JCFG, image_size=IMG)
    model = SupervisedAE(TCFG, 3, IMG)
    model.load_state_dict(to_tensors(sae_to_torch_state_dict(
        params, state, TCFG, IMG)), strict=True)
    opt_j, opt_t = jax_adam_init(params), optim.adam_init(
        list(model.parameters()))
    step = jax.jit(ae_train_step_body(JCFG, JDATA))
    pre_t, pre_j = (_PreBNBiases(model, JCFG.bn_momentum) for _ in "tj")
    rng = np.random.default_rng(0)
    for s in range(5):
        pre_t.record(model.state_dict())
        pre_j.record(sae_to_torch_state_dict(params, state, TCFG, IMG))
        imgs, labels = _u8(B, seed=10 + s), rng.integers(0, 10, B)
        k = jax.random.fold_in(key, s)
        params, state, opt_j, m_j = step(
            params, state, opt_j, jnp.asarray(imgs),
            jnp.asarray(labels, jnp.int32), k, jnp.float32(ALPHA),
            jnp.float32(AE_LR))
        m_t, grads = ae_train_step(model, opt_t, _t(imgs), _t(labels), ALPHA,
                                   AE_LR, TDATA, **_satae_aug_draws(k, B))
        assert len(grads) == len(list(model.parameters()))
        for name in ("loss", "mse", "ce"):
            np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                       rtol=1e-5, err_msg=f"{name} step {s}")
        assert float(m_t["acc"]) == float(m_j["acc"])
    _assert_state_close(model, sae_to_torch_state_dict(
        jax.device_get(params), jax.device_get(state), TCFG, IMG),
        pre_t, pre_j)


def test_mlp_train_steps_match_satae():
    key = jax.random.PRNGKey(1)
    params, state = mlp_init(key, JCFG)
    model = MLP(TCFG)
    model.load_state_dict(to_tensors(mlp_to_torch_state_dict(
        params, state, TCFG)), strict=True)
    opt_j, opt_t = jax_adam_init(params), optim.adam_init(
        list(model.parameters()))
    step = make_mlp_train_step(JCFG, donate=False)
    pre_t, pre_j = (_PreBNBiases(model, JCFG.bn_momentum) for _ in "tj")
    rng = np.random.default_rng(1)
    for s in range(5):
        pre_t.record(model.state_dict())
        pre_j.record(mlp_to_torch_state_dict(params, state, TCFG))
        x = rng.normal(size=(B, JCFG.latent_dim)).astype(np.float32)
        labels = rng.integers(0, 10, B)
        k = jax.random.fold_in(key, s)
        params, state, opt_j, m_j = step(
            params, state, opt_j, jnp.asarray(x),
            jnp.asarray(labels, jnp.int32), k, jnp.float32(MLP_LR),
            jnp.float32(WD))
        mask = _t(jax.random.bernoulli(k, 1 - JCFG.mlp_dropout,
                                       (B, JCFG.mlp_hidden[0])))
        m_t, _ = mlp_train_step(model, opt_t, _t(x), _t(labels), MLP_LR, WD,
                                dropout_mask=mask)
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5, err_msg=f"step {s}")
    _assert_state_close(model, mlp_to_torch_state_dict(
        jax.device_get(params), jax.device_get(state), TCFG), pre_t, pre_j)


def test_eval_steps_and_predict_match_satae():
    ae_p, ae_s = supervised_ae_init(jax.random.PRNGKey(3), JCFG,
                                    image_size=IMG)
    ae = SupervisedAE(TCFG, 3, IMG)
    ae.load_state_dict(to_tensors(sae_to_torch_state_dict(
        ae_p, ae_s, TCFG, IMG)), strict=True)
    imgs, labels = _u8(B, seed=6), np.arange(B) % 10
    ref = ae_eval_step_body(JCFG)(ae_p, ae_s, jnp.asarray(imgs),
                                  jnp.asarray(labels, jnp.int32), ALPHA)
    out = ae_eval_step(ae, _t(imgs), _t(labels), ALPHA)
    mlp_p, mlp_s = mlp_init(jax.random.PRNGKey(4), JCFG)
    mlp = MLP(TCFG)
    mlp.load_state_dict(to_tensors(mlp_to_torch_state_dict(
        mlp_p, mlp_s, TCFG)), strict=True)
    x = np.random.default_rng(7).normal(size=(B, JCFG.latent_dim)).astype(
        np.float32)
    ref_m = make_mlp_eval_step(JCFG)(mlp_p, mlp_s, jnp.asarray(x),
                                     jnp.asarray(labels, jnp.int32))
    out_m = mlp_eval_step(mlp, _t(x), _t(labels))
    for ours, theirs in ((out, ref), (out_m, ref_m)):
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]),
                                       rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(
        mlp_predict(mlp, _t(x)).numpy(),
        np.asarray(make_mlp_predict(JCFG)(mlp_p, mlp_s, jnp.asarray(x))))


def test_extract_features_matches_satae():
    params, state = supervised_ae_init(jax.random.PRNGKey(2), JCFG,
                                       image_size=IMG)
    model = SupervisedAE(TCFG, 3, IMG)
    model.load_state_dict(to_tensors(sae_to_torch_state_dict(
        params, state, TCFG, IMG)), strict=True)
    imgs, labels = _u8(20, seed=4), np.arange(20, dtype=np.int32) % 10
    ref_x, ref_y = jax_extract(params["encoder"], state["encoder"],
                               JaxArrayDataset(imgs, labels), JCFG, B)
    x, y = extract_features(model.enc.eval(), ArrayDataset(imgs, labels), B)
    assert x.shape == ref_x.shape and x.dtype == np.float32
    np.testing.assert_allclose(x, ref_x, atol=1e-4)
    np.testing.assert_array_equal(y, ref_y)


def test_epoch_order_and_eval_batches_identical():
    for n, seed, epoch in [(70, 0, 0), (70, 3, 5), (8, 1, 2)]:
        np.testing.assert_array_equal(hbm.epoch_order(n, B, seed, epoch),
                                      jax_hbm.epoch_order(n, B, seed, epoch))
    imgs, labels = _u8(13, seed=5), np.arange(13, dtype=np.int32)
    for a, b in zip(hbm.padded_eval_batches(ArrayDataset(imgs, labels), B),
                    jax_hbm.padded_eval_batches(
                        JaxArrayDataset(imgs, labels), B)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# val losses of successive epochs: a stop on patience, and a run that reaches
# max_epochs while still improving
SCRIPTS = {"patience_stop": [5.0, 4.0, 4.5, 3.0, 3.2, 3.1, 3.05, 3.5, 2.0],
           "max_epochs": [5.0, 4.0, 4.5, 3.0, 3.2, 2.9]}


def _satae_scripted(val_losses, patience, max_epochs):
    """satae's pipelined trainer with its epoch programs replaced by the
    script; fc2's bias marks the epoch whose weights a snapshot holds."""
    calls = {"train": 0, "eval": 0}

    def train_epoch(params, bn, opt, *args):
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["head"]["fc2"]["b"] = jnp.full_like(params["head"]["fc2"]["b"],
                                                   calls["train"])
        calls["train"] += 1
        one = jnp.float32(1.0)
        return params, bn, opt, {"loss": one, "mse": one, "ce": one,
                                 "acc": one}

    def eval_sums(*args):
        v = jnp.float32(val_losses[calls["eval"] % len(val_losses)])
        calls["eval"] += 1
        return {"loss": v, "mse": v, "ce": v, "acc": jnp.float32(0.5),
                "n": jnp.float32(1.0)}

    engine = type("Engine", (), dict(
        model_cfg=JCFG, data_cfg=JDATA, compute_dtype=jnp.float32, mesh=None,
        mesh_axis="data", train_epoch=staticmethod(train_epoch),
        eval_sums=staticmethod(eval_sums)))()
    ds = JaxArrayDataset(np.zeros((B, IMG, IMG, 3), np.uint8),
                         np.zeros(B, np.int32))
    res = jax_fast_loop.train_supervised_ae_scan(
        ds, ds, model_cfg=JCFG, data_cfg=JDATA, alpha=ALPHA, lr=AE_LR,
        max_epochs=max_epochs, patience=patience, engine=engine,
        device_data=(None,) * 5)
    return res, float(res.params["head"]["fc2"]["b"][0])


def _port_scripted(val_losses, patience, max_epochs, monkeypatch):
    calls = {"train": 0, "eval": 0}

    def train_epoch(model, *args):
        with torch.no_grad():
            model.classifier[2].bias.fill_(calls["train"])
        calls["train"] += 1
        return {k: torch.tensor(1.0) for k in ("loss", "mse", "ce", "acc")}

    def eval_sums(*args):
        v = torch.tensor(val_losses[calls["eval"] % len(val_losses)])
        calls["eval"] += 1
        return {"loss": v, "mse": v, "ce": v, "acc": torch.tensor(0.5),
                "n": torch.tensor(1.0)}

    monkeypatch.setattr(hbm, "ae_train_epoch", train_epoch)
    monkeypatch.setattr(hbm, "ae_eval_sums", eval_sums)
    ds = ArrayDataset(np.zeros((B, IMG, IMG, 3), np.uint8),
                      np.zeros(B, np.int32))
    res = fast_loop.train_supervised_ae(
        ds, ds, model_cfg=TCFG, data_cfg=TDATA, alpha=ALPHA, lr=AE_LR,
        device=torch.device("cpu"), max_epochs=max_epochs, patience=patience)
    return res, float(res.params["classifier.2.bias"][0])


@pytest.mark.parametrize("script", SCRIPTS)
def test_early_stopping_bookkeeping_matches_satae(script, monkeypatch):
    losses_ = SCRIPTS[script]
    ref, ref_marker = _satae_scripted(losses_, 3, len(losses_))
    res, marker = _port_scripted(losses_, 3, len(losses_), monkeypatch)
    assert (res.best_epoch, res.epochs_run, res.best_val_loss) == (
        ref.best_epoch, ref.epochs_run, ref.best_val_loss)
    assert res.history["val_loss"] == pytest.approx(ref.history["val_loss"])
    # the returned weights are the best epoch's, not the last one's
    assert marker == ref_marker == ref.best_epoch
    if script == "patience_stop":
        assert res.epochs_run == 7 < len(losses_)


def test_init_bounds_and_fans_match_satae(monkeypatch):
    """The bound of every weight and bias draw, in parameter order, equals
    the one satae's initialisers use (values differ: other streams)."""
    drawn = []
    real = jax_init._uniform

    def spy(key, shape, bound, dtype=jnp.float32):
        drawn.append((int(np.prod(shape)), bound))
        return real(key, shape, bound, dtype)

    monkeypatch.setattr(jax_init, "_uniform", spy)
    for init, model in ((lambda: supervised_ae_init(
            jax.random.PRNGKey(0), JCFG, image_size=IMG),
            SupervisedAE(TCFG, 3, IMG)),
            (lambda: mlp_init(jax.random.PRNGKey(0), JCFG), MLP(TCFG))):
        drawn.clear()
        init()
        bounds = TInit.default_bounds(model)
        ours = [(p.numel(), bounds[name])
                for name, p in model.named_parameters() if name in bounds]
        assert len(ours) == len(drawn)
        for (n_a, b_a), (n_b, b_b) in zip(ours, drawn):
            assert n_a == n_b
            assert b_a == pytest.approx(b_b, rel=1e-12)
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(7.0)
        TInit.init_(model, torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            top = float(p.detach().abs().max())
            if name in bounds:
                assert top <= bounds[name], name
                assert p.numel() < 64 or top > 0.9 * bounds[name], name
            else:  # BatchNorm
                assert set(p.unique().tolist()) <= {0.0, 1.0}, name
