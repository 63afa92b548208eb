"""``satae_torch.fit`` end to end on the CPU at a tiny config (channels
(4, 8), latent 8, head 16, MLP (16, 8), 16x16 images, batch 8), synthetic
data with 8 images per class, 2 AE and 2 MLP epochs: the FitSummary contract
of satae, the fitted pipeline's predict, the reuse_ae flow, the refusals,
``debug_nans`` and ``load_torch`` keeping a loaded MLP.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from satae import config as JC
from satae.api import FitSummary as JaxFitSummary
from satae.api import SatAEPipeline as JaxPipeline
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from torch_port_threads import two_threads  # noqa: F401 (autouse)
import satae_torch
from satae_torch import api as tapi
from satae_torch import config as TC
from satae_torch.api import SatAEPipeline
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
CFG = TC.PipelineConfig(
    data=TC.DataConfig(per_class=8, image_size=16, batch_size=8),
    model=TCFG, ae=TC.AETrainConfig(max_epochs=2),
    mlp=TC.MLPTrainConfig(epochs=2))
STAGES = ["data", "ae", "extract", "mlp", "eval"]


@pytest.fixture(scope="module")
def test_split():
    return make_splits(load_dataset(CFG.data), CFG.data).test


def test_fit_end_to_end(test_split):
    lines = []
    pipe = SatAEPipeline(CFG, device="cpu")
    summary = pipe.fit(log=lines.append)
    assert isinstance(summary, satae_torch.FitSummary)
    assert [f.name for f in dataclasses.fields(summary)] == [
        f.name for f in dataclasses.fields(JaxFitSummary)]
    assert list(summary.stage_seconds) == STAGES
    assert summary.ae_hparams == {"alpha": 35.0, "lr": 5e-3}
    assert summary.mlp_hparams == {"lr": 1e-4}
    assert np.isfinite(summary.ae_val_loss)
    assert 0.0 <= summary.mlp_val_acc <= 1.0
    assert len(lines) == 2 + 2  # one line per epoch
    assert [len(pipe.history[k]["train_loss"]) for k in ("ae", "mlp")] == [
        2, 2]
    assert not pipe.ae.training and not pipe.mlp.training
    preds = pipe.predict(test_split.images)
    assert preds.shape == (len(test_split),)
    assert summary.test_acc == float((preds == test_split.labels).mean())
    # the module-level fit: the same config and seed fit the same weights
    again = satae_torch.fit(CFG, device="cpu")
    np.testing.assert_array_equal(again.predict(test_split.images), preds)


def test_reuse_ae_after_load_trains_only_the_mlp(tmp_path, test_split):
    """A satae run directory loaded into the port: fit(reuse_ae=True) keeps
    its autoencoder bit for bit and trains a new MLP on its latents."""
    ae_p, ae_s = supervised_ae_init(jax.random.PRNGKey(0), JCFG,
                                    image_size=16)
    mlp_p, mlp_s = mlp_init(jax.random.PRNGKey(1), JCFG)
    jp = JaxPipeline(JC.PipelineConfig(
        data=JC.DataConfig(per_class=8, image_size=16, batch_size=8),
        model=JCFG))
    jp.ae_params, jp.ae_bn_state, jp.mlp_params, jp.mlp_bn_state = (
        ae_p, ae_s, mlp_p, mlp_s)
    jp.save(str(tmp_path))
    pipe = SatAEPipeline(CFG, device="cpu").load(str(tmp_path))
    ae_before = {k: v.clone() for k, v in pipe.ae.state_dict().items()}
    mlp_before = {k: v.clone() for k, v in pipe.mlp.state_dict().items()}
    summary = pipe.fit(reuse_ae=True)
    assert summary.ae_val_loss is None
    assert summary.ae_hparams == {"reused": True}
    assert pipe.history["ae"] is None and pipe.history["mlp"]
    assert list(summary.stage_seconds) == STAGES
    for k, v in pipe.ae.state_dict().items():
        assert torch.equal(v, ae_before[k]), k
    assert any(not torch.equal(v, mlp_before[k])
               for k, v in pipe.mlp.state_dict().items())
    preds = pipe.predict(test_split.images)
    assert summary.test_acc == float((preds == test_split.labels).mean())


def test_fit_refusals(monkeypatch, tmp_path):
    """What is not ported raises before any work, naming its ROADMAP item:
    the sharded sweep engines and the multi-process runtime (item 8); and a
    fit never drops to the CPU by itself. In-flight resume, the grid's curve
    figures and the vmap sweep engine (``parallel_configs``), refused until
    they were ported, now run."""
    run = tmp_path / "run"
    rt = lambda **kw: dataclasses.replace(CFG, runtime=TC.RuntimeConfig(**kw))
    with pytest.raises(NotImplementedError, match="item 8"):
        SatAEPipeline(rt(n_devices=2), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        SatAEPipeline(rt(multihost=True), device="cpu")
    with pytest.raises(ValueError, match="reuse_ae"):
        SatAEPipeline(CFG, device="cpu").fit(reuse_ae=True)
    assert not run.exists()
    # a 1 x 1 grid: alpha 20, lr 1e-3; MLP lr 1e-4
    small = dataclasses.replace(
        CFG, ae=dataclasses.replace(CFG.ae, alphas=(20.0,),
                                    learning_rates=(1e-3,)),
        mlp=dataclasses.replace(CFG.mlp, learning_rates=(1e-4,)))
    resume = dataclasses.replace(small, ae=dataclasses.replace(
        small.ae, checkpoint_every=1))
    for grid in (False, True):
        out = tmp_path / f"resume_{grid}"
        SatAEPipeline(resume, device="cpu").fit(grid=grid, out_dir=str(out))
        assert (out / "ae_global_best.msgpack").exists()
        assert not list((out / "inflight").iterdir())
    vmap = tmp_path / "vmap"
    engines = []
    monkeypatch.setattr(tapi, "ae_vmap_grid_search", _spying(
        tapi.ae_vmap_grid_search, engines))
    monkeypatch.setattr(tapi, "mlp_vmap_grid_search", _spying(
        tapi.mlp_vmap_grid_search, engines))
    vsum = SatAEPipeline(dataclasses.replace(
        small, ae=dataclasses.replace(small.ae, learning_rates=(1e-3, 5e-3)),
        runtime=TC.RuntimeConfig(parallel_configs=True)),
        device="cpu").fit(grid=True, out_dir=str(vmap))
    assert engines == ["ae_vmap_grid_search", "mlp_vmap_grid_search"]
    assert vsum.ae_hparams["lr"] in (1e-3, 5e-3)
    assert len(json.loads((vmap / "validation_losses.json").read_text())) == 2
    curves = tmp_path / "curves"
    SatAEPipeline(dataclasses.replace(small, runtime=TC.RuntimeConfig(
        save_grid_curves=True)), device="cpu").fit(grid=True,
                                                   out_dir=str(curves))
    assert sorted(f.name for f in (curves / "curves").iterdir()) == [
        "ae_alpha20_lr0.001.png", "mlp_lr0.0001.png"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        satae_torch.fit(CFG, grid=True)


def _spying(fn, calls):
    def wrapped(*a, **kw):
        calls.append(fn.__name__)
        return fn(*a, **kw)
    return wrapped


def _poison_first_batch(monkeypatch):
    """A NaN in the first augmented training batch of the next fit."""
    from satae_torch.train import steps
    orig, calls = steps.augment_train_batch, [0]

    def augment(*a, **k):
        x = orig(*a, **k)
        calls[0] += 1
        if calls[0] == 1:
            x = x.clone()
            x[0, 0, 0, 0] = float("nan")
        return x
    monkeypatch.setattr(steps, "augment_train_batch", augment)


def test_debug_nans_raises_at_the_first_non_finite_step(monkeypatch):
    """runtime.debug_nans, as satae's jax_debug_nans: a fit whose first
    batch holds a NaN raises FloatingPointError; the same fit without the
    flag runs to its end (its losses NaN)."""
    cfg = dataclasses.replace(CFG, runtime=TC.RuntimeConfig(debug_nans=True))
    _poison_first_batch(monkeypatch)
    with pytest.raises(FloatingPointError, match="non-finite loss in the AE"):
        SatAEPipeline(cfg, device="cpu").fit()
    _poison_first_batch(monkeypatch)
    pipe = SatAEPipeline(CFG, device="cpu")
    summary = pipe.fit()
    assert not np.isfinite(pipe.history["ae"]["train_loss"][0])
    assert 0.0 <= summary.test_acc <= 1.0
    # the MLP steps are checked too, and a finite fit passes the checks
    fine = SatAEPipeline(cfg, device="cpu").fit()
    assert np.isfinite(fine.ae_val_loss)


def test_load_torch_without_mlp_keeps_the_loaded_mlp(tmp_path, test_split):
    """load() then load_torch(ae_pt) replaces the autoencoder only, as in
    satae: predict still works and equals satae's after the same calls."""
    ae_p, ae_s = supervised_ae_init(jax.random.PRNGKey(0), JCFG,
                                    image_size=16)
    mlp_p, mlp_s = mlp_init(jax.random.PRNGKey(1), JCFG)
    jcfg = JC.PipelineConfig(
        data=JC.DataConfig(per_class=8, image_size=16, batch_size=8),
        model=JCFG)
    jp = JaxPipeline(jcfg)
    jp.ae_params, jp.ae_bn_state, jp.mlp_params, jp.mlp_bn_state = (
        ae_p, ae_s, mlp_p, mlp_s)
    jp.save(str(tmp_path / "run"))
    other_p, other_s = supervised_ae_init(jax.random.PRNGKey(2), JCFG,
                                          image_size=16)
    jp.ae_params, jp.ae_bn_state = other_p, other_s
    jp.export_torch(str(tmp_path / "pt"))
    ae_pt = str(tmp_path / "pt" / "AE_GLOBAL_BEST.pt")
    ours = SatAEPipeline(CFG, device="cpu").load(str(tmp_path / "run"))
    mlp = ours.mlp
    ours.load_torch(ae_pt)
    assert ours.mlp is mlp
    theirs = JaxPipeline(jcfg).load(str(tmp_path / "run")).load_torch(ae_pt)
    np.testing.assert_array_equal(ours.predict(test_split.images),
                                  theirs.predict(test_split.images))
