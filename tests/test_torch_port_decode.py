"""Decoder serving of the port against satae's, on the CPU: ``decode``,
``reconstruct`` and ``reconstruct_batched`` on the same carried weights
(satae trees drawn from numpy, non-trivial BatchNorm, saved by satae and
loaded by the port), a tiny model (latent 8, channels (4, 8), 16x16 images)
at the default batch 64, so both serving chunks run: n = 1 (one chunk of
64), 65 (one of 512) and 513 (two of 512), and n = 0.

Tolerances: float32 within 1e-5 absolute (the transposed convolutions sum
in another order: satae's subpixel form against F.conv_transpose2d;
measured 8.9e-8); bf16 within 2^-6 absolute, four bf16 roundings of values
in [0, 1] between the two (the port's K1 rounds the decoder input once
where satae's XLA linear rounds twice, satae_torch/nn/layers.py; measured
4.0e-3). The ``slow`` test reconstructs the 2,990-image synthetic-hard test
split through the committed full-width models and holds the mean
reconstruction MSE to satae's within 1e-5 relative in float32 and 1e-3 in
bf16 (measured 8.9e-8 and 3.6e-5), the bounds chip_smoke.py's phase 17
holds the card to.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from satae import config as JC
from satae.api import SatAEPipeline as JaxPipeline
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.api import SatAEPipeline
from satae_torch.train import calibrate as tcal
from test_torch_port_models import numpy_trees

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG = 16
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
SIZES = (0, 1, 65, 513)


def _cfgs(dtype):
    j = JC.PipelineConfig(data=JC.DataConfig(image_size=IMG), model=JCFG,
                          runtime=JC.RuntimeConfig(compute_dtype=dtype))
    t = TC.PipelineConfig(data=TC.DataConfig(image_size=IMG), model=TCFG,
                          runtime=TC.RuntimeConfig(compute_dtype=dtype))
    return j, t


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    run = tmp_path_factory.mktemp("decode_run")
    jp = JaxPipeline(_cfgs("float32")[0])
    jp.ae_params, jp.ae_bn_state = numpy_trees(supervised_ae_init, JCFG,
                                               image_size=IMG, seed=5)
    jp.mlp_params, jp.mlp_bn_state = numpy_trees(mlp_init, JCFG, seed=6)
    jp.save(str(run))
    return run


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, (max(SIZES), IMG, IMG, 3),
                                             dtype=np.uint8)


def _pair(run, dtype, ae_only=False):
    j, t = _cfgs(dtype)
    load = "load_ae" if ae_only else "load"
    return (getattr(JaxPipeline(j), load)(str(run)),
            getattr(SatAEPipeline(t, device="cpu"), load)(str(run)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_reconstruct_matches_satae(run_dir, images, dtype, n):
    theirs, ours = _pair(run_dir, dtype)
    x = images[:n]
    want = theirs.reconstruct(x)
    for got in (ours.reconstruct(x), ours.reconstruct_batched(x)):
        assert got.shape == want.shape == (n, IMG, IMG, 3)
        assert got.dtype == np.float32
        if n:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
            assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_decode_matches_satae(run_dir, dtype, n):
    theirs, ours = _pair(run_dir, dtype)
    z = np.random.default_rng(n).normal(size=(n, JCFG.latent_dim))
    want, got = theirs.decode(z), ours.decode(z)
    assert got.shape == want.shape == (n, IMG, IMG, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


def test_reconstruct_is_decode_of_encode(run_dir, images):
    _, ours = _pair(run_dir, "float32")
    x = images[:70]
    np.testing.assert_array_equal(ours.decode(ours.encode(x)),
                                  ours.reconstruct(x))


@pytest.mark.parametrize("bad", [(5, 9), (5,), (2, 4, 8)])
def test_decode_refuses_bad_latents(run_dir, bad):
    theirs, ours = _pair(run_dir, "float32")
    z = np.zeros(bad, np.float32)
    for pipe in (theirs, ours):
        with pytest.raises(ValueError, match="latents must be"):
            pipe.decode(z)


def test_ae_only_pipeline_serves_the_decoder(run_dir, images):
    theirs, ours = _pair(run_dir, "float32", ae_only=True)
    assert ours.mlp is None
    x = images[:65]
    np.testing.assert_allclose(ours.reconstruct(x), theirs.reconstruct(x),
                               rtol=0, atol=TOL["float32"])
    with pytest.raises(RuntimeError, match="no classifier"):
        ours.predict(x)
    with pytest.raises(RuntimeError, match="not loaded"):
        SatAEPipeline(_cfgs("float32")[1], device="cpu").reconstruct(x)


@pytest.mark.parametrize("entry", ["decode", "reconstruct_batched",
                                   "calibrate"])
def test_convolutions_run_in_float32(run_dir, images, entry, monkeypatch):
    """Every convolution of decoder serving and of calibration runs with
    cuDNN's TF32 off, as satae computes them in float32, and with its
    deterministic algorithms, so a call repeats bit for bit on the card,
    whatever the caller's flags; the caller's flags come back afterwards."""
    seen = []
    cudnn = torch.backends.cudnn

    def spy(real):
        def conv(*args, **kw):
            seen.append((cudnn.allow_tf32, cudnn.deterministic))
            return real(*args, **kw)
        return conv
    for name in ("conv2d", "conv_transpose2d"):
        monkeypatch.setattr(F, name, spy(getattr(F, name)))
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    _, ours = _pair(run_dir, "float32")
    if entry == "decode":
        ours.decode(np.zeros((3, JCFG.latent_dim), np.float32))
    elif entry == "reconstruct_batched":
        ours.reconstruct_batched(images[:3])
    else:
        tcal.loss_ratio_calibration(images[:8], np.arange(8) % 10,
                                    model_cfg=TCFG, n_inits=2, device="cpu")
    assert seen and set(seen) == {(False, True)}
    assert cudnn.allow_tf32 and not cudnn.deterministic


@pytest.mark.slow
@pytest.mark.parametrize("dtype,ckpt,rtol", [
    ("float32", "full_run_hard_f32", 1e-5),
    ("bfloat16", "full_run_hard_bf16", 1e-3)])
def test_full_split_reconstruction_mse_matches_satae(dtype, ckpt, rtol):
    from satae.data.ingest import load_dataset
    from satae.data.pipeline import make_splits
    repo = Path(__file__).resolve().parent.parent
    data = JC.DataConfig(per_class=2000, synthetic_difficulty="hard")
    test = make_splits(load_dataset(data), data).test
    run = str(repo / "benchmarks" / ckpt)
    theirs = JaxPipeline(JC.PipelineConfig(
        data=data, runtime=JC.RuntimeConfig(compute_dtype=dtype))).load(run)
    ours = SatAEPipeline(TC.PipelineConfig(runtime=TC.RuntimeConfig(
        compute_dtype=dtype)), device="cpu").load(run)
    x = test.images.astype(np.float32) / 255.0
    mse = [float(np.mean(np.square(p.reconstruct_batched(test.images) - x)))
           for p in (theirs, ours)]
    assert abs(mse[1] - mse[0]) <= rtol * mse[0]
