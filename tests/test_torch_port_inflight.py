"""In-flight resume (``AETrainConfig.checkpoint_every`` with ``out_dir``) of
the port against satae's, on the CPU at the tiny config of
tests/test_torch_port_fit.py (channels (4, 8), latent 8, 16x16 images,
batch 8, synthetic data with 8 images per class).

(a) the train-state pair is satae's: the ``.msgpack`` bytes equal flax's,
the meta equal, and each package reads the other's files into equal trees
(parameters, BatchNorm stats, Adam's moments and step, epoch, history), at
the file level and through each package's trainer; (b) a fit killed after
epoch k (an injected exception) and run again resumes at k + 1 and ends bit
for bit where the uninterrupted fit ends (the augmentation generator's state
travels in the meta); (c) the files carry satae's names and are removed only
once the result is recorded. Every comparison is exact.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from satae import config as JC
from satae.io import checkpoint as jckpt
from satae.models.supervised_ae import supervised_ae_init
from satae.train import fast_loop as jfast
from satae.train.optim import adam_init as jax_adam_init
from torch_port_threads import two_threads  # noqa: F401 (autouse)
import satae_torch.api as tapi
from satae_torch import config as TC
from satae_torch.api import SatAEPipeline
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.io import checkpoint, convert
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn.init import init_
from satae_torch.train import fast_loop as tfast
from satae_torch.train import hbm
from satae_torch.train.optim import adam_init
from satae_torch.utils.strict_json import dump_strict_json
from test_torch_port_models import numpy_trees

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, B = 16, 8
TDATA = TC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
JDATA = JC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
CFG = TC.PipelineConfig(data=TDATA, model=TCFG,
                        ae=TC.AETrainConfig(max_epochs=3, checkpoint_every=1),
                        mlp=TC.MLPTrainConfig(epochs=2))
FIELDS = ("ae_val_loss", "ae_hparams", "mlp_val_acc", "mlp_hparams",
          "test_acc")


@pytest.fixture(scope="module")
def splits():
    return make_splits(load_dataset(TDATA), TDATA)


def _to_trees(sd):
    return convert.sae_from_torch_state_dict(sd, TCFG, image_size=IMG)


def _from_trees(p, s):
    return convert.to_tensors(convert.sae_to_torch_state_dict(
        p, s, TCFG, image_size=IMG))


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


def _templates():
    p, s = supervised_ae_init(jax.random.PRNGKey(0), JCFG, image_size=IMG)
    return jax.device_get(p), jax.device_get(s), \
        jax.device_get(jax_adam_init(p))


def _trained_model(splits, steps=2):
    """A port AE, its Adam state and generator after ``steps`` real steps."""
    model = init_(SupervisedAE(TCFG, image_size=IMG),
                  torch.Generator().manual_seed(1))
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator().manual_seed(2)
    imgs = torch.from_numpy(splits.train.images)
    labels = torch.from_numpy(splits.train.labels).long()
    hbm.ae_train_epoch(model, opt, imgs, labels,
                       hbm.epoch_order(len(imgs), B, 0, 0)[:steps], 35.0,
                       5e-3, TDATA, gen)
    return model, opt, gen


# -- (a) the files -------------------------------------------------------------

def test_train_state_files_equal_satae(tmp_path):
    p, s = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=3)
    mu, _ = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=4)
    nu, _ = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=5)
    opt = {"mu": mu, "nu": nu, "step": np.asarray(7, np.int32)}
    extra = {"best_val": float("inf"), "best_val_acc": 0.25, "best_epoch": -1,
             "bad": 2, "history": {"val_loss": [1.5, float("nan")]}}
    for save, d in ((checkpoint.save_train_state, "port"),
                    (jckpt.save_train_state, "satae")):
        save(tmp_path / d / "s.msgpack", params=p, bn_state=s, opt_state=opt,
             epoch=4, extra=extra)
    for name in ("s.msgpack", "s.state.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "satae" / name).read_bytes(), name
    got = checkpoint.load_train_state(tmp_path / "satae" / "s.msgpack")
    _assert_trees_equal(got[:3], (p, s, opt))
    theirs = jckpt.load_train_state(
        tmp_path / "port" / "s.msgpack", params_like=p, bn_state_like=s,
        opt_state_like=opt)[3]
    assert dump_strict_json(got[3]) == dump_strict_json(theirs)  # NaN too
    checkpoint.clear_train_state(tmp_path / "port" / "s.msgpack")
    assert not list((tmp_path / "port").iterdir())


def test_port_flush_read_by_satae(tmp_path, splits):
    model, opt, gen = _trained_model(splits)
    path = tmp_path / "inflight" / "ae.msgpack"
    best = tfast._snapshot(model)
    hist = {"val_loss": [2.0, 1.5]}
    tfast._Inflight(str(path), model, opt, gen, TCFG, TDATA).flush(
        1, best, {"best_val": 1.5, "bad": 0, "history": hist})
    p, s, o, meta = jckpt.load_train_state(path, **dict(zip(
        ("params_like", "bn_state_like", "opt_state_like"), _templates())))
    _assert_trees_equal((p, s), _to_trees(model.state_dict()))
    names = [n for n, _ in model.named_parameters()]
    sd = model.state_dict()
    for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
        want = _to_trees({**sd, **dict(zip(names, moments))})[0]
        _assert_trees_equal(o[key], want)
    assert int(o["step"]) == opt.step == 2
    assert meta["epoch"] == 1 and meta["history"] == hist
    assert meta["torch_generator"] == gen.get_state().numpy().tobytes().hex()
    bp, bb = jckpt.load_model(path.with_suffix(".best.msgpack"),
                              *_templates()[:2])
    _assert_trees_equal((bp, bb), _to_trees({**best[0], **best[1]}))


def test_satae_files_read_by_port(tmp_path):
    p, s = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=3)
    mu, _ = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=4)
    nu, _ = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=5)
    path = tmp_path / "ae.msgpack"
    jckpt.save_train_state(path, params=p, bn_state=s, opt_state={
        "mu": mu, "nu": nu, "step": np.asarray(9, np.int32)}, epoch=3,
        extra={"best_val": 0.5, "history": {"val_loss": [0.7, 0.5]}})
    model = SupervisedAE(TCFG, image_size=IMG)
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    meta, best = tfast._Inflight(str(path), model, opt, gen, TCFG,
                                 TDATA).restore()
    assert best is None  # satae wrote no .best.msgpack here
    _assert_trees_equal(_to_trees(model.state_dict()), (p, s))
    names = [n for n, _ in model.named_parameters()]
    for moments, tree in ((opt.mu, mu), (opt.nu, nu)):
        sd = {**model.state_dict(), **dict(zip(names, moments))}
        _assert_trees_equal(_to_trees(sd)[0], tree)
    assert opt.step == 9 and meta["epoch"] == 3
    assert meta["history"] == {"val_loss": [0.7, 0.5]}
    assert torch.equal(gen.get_state(), before)  # satae's has no torch state


def test_trainers_resume_each_others_files(tmp_path, splits):
    """satae's trainer writes its in-flight files after one epoch; the
    port's resumes them at epoch 1 and, at max_epochs 1, returns satae's
    best snapshot, history and counts. Then the other way round."""
    kw = dict(alpha=35.0, lr=5e-3, max_epochs=1, seed=0, checkpoint_every=1)
    jpath, tpath = tmp_path / "j" / "ae.msgpack", tmp_path / "t" / "ae.msgpack"
    jres = jfast.train_supervised_ae_scan(
        splits.train, splits.val, model_cfg=JCFG, data_cfg=JDATA,
        checkpoint_path=str(jpath), **kw)
    lines = []
    tres = tfast.train_supervised_ae(
        splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
        device=torch.device("cpu"), checkpoint_path=str(jpath),
        log=lines.append, **kw)
    assert lines == [f"resumed from {jpath} at epoch 1"]
    ours = _to_trees(tres.state_dict())
    _assert_trees_equal(ours, (jres.params, jres.bn_state))
    for f in ("best_val_loss", "best_val_acc", "best_epoch", "epochs_run",
              "history"):
        assert getattr(tres, f) == getattr(jres, f), f

    tres = tfast.train_supervised_ae(
        splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
        device=torch.device("cpu"), checkpoint_path=str(tpath), **kw)
    lines = []
    jres = jfast.train_supervised_ae_scan(
        splits.train, splits.val, model_cfg=JCFG, data_cfg=JDATA,
        checkpoint_path=str(tpath), log=lines.append, **kw)
    assert lines == [f"resumed from {tpath} at epoch 1"]
    _assert_trees_equal(jax.device_get((jres.params, jres.bn_state)),
                        _to_trees(tres.state_dict()))
    for f in ("best_val_loss", "best_val_acc", "best_epoch", "epochs_run",
              "history"):
        assert getattr(tres, f) == getattr(jres, f), f


# -- (b) a killed fit resumes bit for bit -----------------------------------

def _crash_at(monkeypatch, call):
    """Make the ``call``-th AE train epoch (1-based) raise."""
    orig, n = hbm.ae_train_epoch, [0]

    def epoch(*a, **k):
        n[0] += 1
        if n[0] == call:
            raise KeyboardInterrupt("injected kill")
        return orig(*a, **k)
    monkeypatch.setattr(hbm, "ae_train_epoch", epoch)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    pipe = SatAEPipeline(CFG, device="cpu")
    summary = pipe.fit(out_dir=str(tmp_path_factory.mktemp("ref") / "run"))
    return pipe, summary


@pytest.mark.parametrize("k", [0, 1])
def test_fit_killed_after_epoch_k_resumes_bitwise(k, tmp_path, monkeypatch,
                                                  uninterrupted):
    run = tmp_path / "run"
    _crash_at(monkeypatch, k + 2)
    with pytest.raises(KeyboardInterrupt):
        SatAEPipeline(CFG, device="cpu").fit(out_dir=str(run))
    state = json.loads((run / "inflight" / "ae_single.state.json")
                       .read_text())
    assert state["epoch"] == k
    monkeypatch.undo()
    lines = []
    pipe = SatAEPipeline(CFG, device="cpu")
    summary = pipe.fit(out_dir=str(run), log=lines.append)
    assert lines[0] == (f"resumed from {run / 'inflight' / 'ae_single.msgpack'}"
                        f" at epoch {k + 1}")
    trained = [ln for ln in lines if ln.startswith("epoch ")]
    assert len(trained) == CFG.ae.max_epochs - k - 1 + CFG.mlp.epochs
    ref_pipe, ref = uninterrupted
    for f in FIELDS:
        assert getattr(summary, f) == getattr(ref, f), f
    assert pipe.history["ae"] == ref_pipe.history["ae"]
    for mod in ("ae", "mlp"):
        ours = getattr(pipe, mod).state_dict()
        for name, v in getattr(ref_pipe, mod).state_dict().items():
            if not name.endswith("num_batches_tracked"):
                assert torch.equal(ours[name], v), (mod, name)
    assert not list((run / "inflight").iterdir())


# -- (c) names and removal ------------------------------------------------------

def test_grid_inflight_files_have_satae_names(tmp_path, monkeypatch):
    cfg = dataclasses.replace(CFG, ae=TC.AETrainConfig(
        alphas=(20.0, 35.0), learning_rates=(1e-3,), max_epochs=2,
        checkpoint_every=1))
    run = tmp_path / "run"
    _crash_at(monkeypatch, 4)  # the second config's second epoch
    with pytest.raises(KeyboardInterrupt):
        SatAEPipeline(cfg, device="cpu").fit(grid=True, out_dir=str(run))
    # the first config is recorded and its files are gone
    assert sorted(f.name for f in (run / "inflight").iterdir()) == [
        "ae_a35_lr0.001.best.msgpack", "ae_a35_lr0.001.msgpack",
        "ae_a35_lr0.001.state.json"]
    assert list(json.loads((run / "validation_losses.json").read_text())) \
        == ['{"alpha": 20.0, "lr": 0.001}']
    monkeypatch.undo()
    lines = []
    SatAEPipeline(cfg, device="cpu").fit(grid=True, out_dir=str(run),
                                         log=lines.append)
    assert lines[0] == "skip cached alpha=20.0 lr=0.001"
    assert lines[1].startswith("resumed from") and lines[1].endswith(
        "ae_a35_lr0.001.msgpack at epoch 1")
    assert not list((run / "inflight").iterdir())


def test_inflight_kept_until_the_winner_is_written(tmp_path, monkeypatch):
    """A kill after the AE stage (here in extraction) keeps the in-flight
    files: the rerun resumes the trained AE instead of training it again,
    and only then are they removed."""
    run = tmp_path / "run"
    inflight = run / "inflight" / "ae_single.msgpack"

    def boom(*a, **k):
        raise RuntimeError("injected extract crash")
    monkeypatch.setattr(tapi, "extract_features", boom)
    with pytest.raises(RuntimeError, match="injected extract crash"):
        SatAEPipeline(CFG, device="cpu").fit(out_dir=str(run))
    assert inflight.exists() and inflight.with_suffix(".state.json").exists()
    monkeypatch.undo()
    lines = []
    SatAEPipeline(CFG, device="cpu").fit(out_dir=str(run), log=lines.append)
    assert lines[0] == f"resumed from {inflight} at epoch {CFG.ae.max_epochs}"
    assert not [ln for ln in lines[:CFG.ae.max_epochs + 1]
                if ln.startswith("epoch ") and "train_loss" in ln]
    assert not inflight.exists()
    assert (run / "ae_global_best.msgpack").exists()
