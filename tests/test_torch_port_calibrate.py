"""Loss-scale calibration and the host batches of the port against satae's,
on the CPU at a tiny model (latent 8, channels (4, 8), 16x16 images).

satae's inits and augmented batch come from JAX's streams, the port's from
torch's, so the ratios of the two functions are other samples of one
distribution. What is held exactly is the experiment: satae's own ratios
(``loss_ratio_calibration``) are reproduced by the port's ``init_ratio`` on
satae's inits carried across and satae's augmented batch injected (within
1e-5 relative: float32 sums in another order), the summary is satae's on the
same ratios, and ``iter_batches`` gives satae's batches bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satae import config as JC
from satae.data.augment import augment_train_batch as jax_augment
from satae.data.pipeline import ArrayDataset as JaxArrayDataset
from satae.data.pipeline import iter_batches as jax_iter_batches
from satae.data.pipeline import num_batches as jax_num_batches
from satae.models.supervised_ae import supervised_ae_init
from satae.train import calibrate as jcal
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.data.pipeline import ArrayDataset, iter_batches, num_batches
from satae_torch.io import convert
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.train import calibrate as tcal

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, N_INITS, SEED = 16, 4, 3


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (8, IMG, IMG, 3), dtype=np.uint8),
            rng.integers(0, 10, 8).astype(np.int32))


def test_init_ratios_equal_satae_on_its_inits(batch):
    imgs_u8, labels = batch
    data_cfg = JC.DataConfig()
    want = jcal.loss_ratio_calibration(imgs_u8, labels, model_cfg=JCFG,
                                       n_inits=N_INITS, seed=SEED)
    # satae's augmented batch and its inits, as loss_ratio_calibration
    # draws them (calibrate.py:47-53, :72-77)
    imgs = np.array(jax_augment(
        jax.random.PRNGKey(SEED), jnp.asarray(imgs_u8),
        crop_padding=data_cfg.crop_padding, noise_std=data_cfg.noise_std,
        rng_impl=data_cfg.aug_rng_impl))
    model = SupervisedAE(TCFG, image_size=IMG)
    got = []
    for i in range(N_INITS):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), i)
        p, s = supervised_ae_init(key, JCFG, image_size=IMG)
        model.load_state_dict(convert.to_tensors(convert.sae_to_torch_state_dict(
            p, s, TCFG, image_size=IMG)))
        got.append(float(tcal.init_ratio(model, torch.from_numpy(imgs),
                                         torch.from_numpy(labels).long())))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_summary_equals_satae_on_the_same_ratios():
    ratios = np.random.default_rng(1).gamma(9.0, 3.5, 1000).astype(np.float32)
    assert dataclasses.asdict(tcal.CalibrationSummary.from_ratios(ratios)) \
        == dataclasses.asdict(jcal.CalibrationSummary.from_ratios(ratios))
    assert [f.name for f in dataclasses.fields(tcal.CalibrationSummary)] == [
        f.name for f in dataclasses.fields(jcal.CalibrationSummary)]


def test_port_calibration_runs_and_repeats(batch):
    imgs_u8, labels = batch
    run = lambda seed: tcal.loss_ratio_calibration(
        imgs_u8, labels, model_cfg=TCFG, n_inits=N_INITS, seed=seed,
        device="cpu")
    a = run(0)
    assert a.shape == (N_INITS,) and a.dtype == np.float32
    assert np.isfinite(a).all() and (a > 0).all()
    assert len(set(a.tolist())) == N_INITS  # every init its own weights
    np.testing.assert_array_equal(run(0), a)
    assert not np.array_equal(run(1), a)
    # satae's default calibration model: latent 128
    full = tcal.loss_ratio_calibration(imgs_u8, labels, n_inits=1,
                                       data_cfg=TC.DataConfig(), device="cpu")
    assert full.shape == (1,) and np.isfinite(full).all()


@pytest.mark.parametrize("shuffle,drop,epoch", [
    (True, False, 0), (True, True, 2), (False, False, 0), (False, True, 1)])
def test_iter_batches_identical_to_satae(shuffle, drop, epoch):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (37, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 37).astype(np.int32)
    kw = dict(shuffle=shuffle, seed=5, epoch=epoch, drop_remainder=drop)
    ours = list(iter_batches(ArrayDataset(images, labels), 8, **kw))
    theirs = list(jax_iter_batches(JaxArrayDataset(images, labels), 8, **kw))
    assert len(ours) == len(theirs) == num_batches(37, 8, drop) == \
        jax_num_batches(37, 8, drop)
    for (xa, ya), (xb, yb) in zip(ours, theirs):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
