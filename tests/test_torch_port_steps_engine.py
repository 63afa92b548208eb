"""The port's per-batch trainers (satae_torch.train.loop, satae's
``engine="steps"``) against satae/train/loop.py.

With the same scripted steps in both packages, the trainers must see the
same batches (the epoch's shuffle, the remainder batch kept, unpadded eval
batches in order), weigh them the same way, stop at the same epoch and
select the same one: histories, best epoch and epochs run equal exactly.
Then the steps engine runs for real through ``ae_grid_search`` and
``mlp_grid_search`` at the tiny config of tests/test_torch_port_grid.py
(16x16 images, batch 10: the 56-image train split is five batches of 10
and one of 6, the 12-image val split one of 10 and one of 2).
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from satae import config as JC
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from satae.train import loop as jloop
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.train import gridsearch as tgrid
from satae_torch.train import loop as tloop
from satae_torch.train import steps as tsteps
from test_torch_port_models import numpy_trees

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, B = 16, 10
JDATA = JC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
TDATA = TC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
CPU = torch.device("cpu")
# per-epoch val loss (AE) / accuracy (MLP) of the scripted steps
AE_VAL = [3.0, 2.0, 2.5, 1.5, 1.6, 1.5, 1.8, 1.0, 0.9]
MLP_VAL = [0.2, 0.5, 0.4, 0.5, 0.7, 0.1]


@pytest.fixture(scope="module")
def splits():
    return make_splits(load_dataset(TDATA), TDATA)


class _Script:
    """Per-call metrics for the train and eval steps of both packages: the
    train step's k-th call returns metrics drawn from a seeded stream, the
    eval step's metrics in epoch e center on ``val[e]``; every call records
    the labels it was given."""

    def __init__(self, keys, val, eval_key, n_eval):
        self.keys, self.val, self.eval_key, self.n_eval = (keys, val,
                                                           eval_key, n_eval)
        self.rng = np.random.default_rng(0)
        self.train_seen, self.eval_seen = [], []

    def train(self, labels):
        self.train_seen.append(np.asarray(labels).tolist())
        return {k: np.float32(self.rng.uniform(0.1, 3.0)) for k in self.keys}

    def eval(self, labels):
        i = len(self.eval_seen)
        self.eval_seen.append(np.asarray(labels).tolist())
        e, b = divmod(i, self.n_eval)
        out = {k: np.float32(0.5 + 0.1 * b) for k in self.keys}
        out[self.eval_key] = np.float32(self.val[e] + 0.01 * b)
        return out


def _torch(metrics):
    return {k: torch.tensor(v) for k, v in metrics.items()}


def _fast_init(monkeypatch, name, init, **kw):
    """satae's loop initialises eagerly; the scripted steps ignore the
    weights, so numpy trees of the same shapes stand in."""
    monkeypatch.setattr(jloop, name, lambda *a, **k: numpy_trees(
        init, JCFG, **kw))


def test_ae_steps_trainer_matches_satae(monkeypatch, splits):
    _fast_init(monkeypatch, "supervised_ae_init", supervised_ae_init,
               image_size=IMG)
    keys = ("loss", "mse", "ce", "acc")
    n_eval = -(-len(splits.val) // B)
    js, ts = (_Script(keys, AE_VAL, "loss", n_eval) for _ in "jt")
    kw = dict(alpha=35.0, lr=1e-3, max_epochs=len(AE_VAL), patience=3,
              seed=4)
    jlog, tlog = [], []
    j = jloop.train_supervised_ae(
        splits.train, splits.val, model_cfg=JCFG, data_cfg=JDATA,
        log=jlog.append,
        train_step=lambda p, s, o, x, y, *a: (p, s, o, js.train(y)),
        eval_step=lambda p, s, x, y, *a: js.eval(y), **kw)
    t = tloop.train_supervised_ae(
        splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA, device=CPU,
        log=tlog.append,
        train_step=lambda m, o, x, y, *a: _torch(ts.train(y)),
        eval_step=lambda m, x, y, *a: _torch(ts.eval(y)), **kw)
    # 1.5 at epoch 3, then three epochs without a lower loss: epochs 4-6
    assert (t.best_epoch, t.epochs_run) == (j.best_epoch, j.epochs_run) \
        == (3, 7)
    assert t.history == j.history and tlog == jlog
    assert (t.best_val_loss, t.best_val_acc) == (j.best_val_loss,
                                                 j.best_val_acc)
    assert ts.train_seen == js.train_seen and ts.eval_seen == js.eval_seen
    # the remainder batch kept, eval unpadded and in order
    sizes = [len(y) for y in ts.train_seen[:6]]
    assert sizes == [10, 10, 10, 10, 10, 6] and len(ts.train_seen) == 7 * 6
    assert [len(y) for y in ts.eval_seen[:2]] == [10, 2]
    assert sum(ts.eval_seen[:2], []) == splits.val.labels.tolist()


def test_mlp_steps_trainer_matches_satae(monkeypatch):
    _fast_init(monkeypatch, "mlp_init", mlp_init)
    rng = np.random.default_rng(3)
    x = {n: rng.standard_normal((n, 8)).astype(np.float32) for n in (46, 13)}
    y = {n: rng.integers(0, 10, n).astype(np.int32) for n in (46, 13)}
    js, ts = (_Script(("loss", "acc"), MLP_VAL, "acc", 2) for _ in "jt")
    kw = dict(lr=1e-3, weight_decay=1e-4, epochs=len(MLP_VAL), batch_size=B,
              seed=2)
    jlog, tlog = [], []
    j = jloop.train_mlp(
        x[46], y[46], x[13], y[13], model_cfg=JCFG, log=jlog.append,
        train_step=lambda p, s, o, xb, yb, *a: (p, s, o, js.train(yb)),
        eval_step=lambda p, s, xb, yb: js.eval(yb), **kw)
    t = tloop.train_mlp(
        x[46], y[46], x[13], y[13], model_cfg=TCFG, device=CPU,
        log=tlog.append,
        train_step=lambda m, o, xb, yb, *a: _torch(ts.train(yb)),
        eval_step=lambda m, xb, yb: _torch(ts.eval(yb)), **kw)
    assert (t.best_epoch, t.epochs_run) == (j.best_epoch, j.epochs_run) \
        == (4, len(MLP_VAL))
    assert t.history == j.history and tlog == jlog
    assert (t.best_val_loss, t.best_val_acc) == (j.best_val_loss,
                                                 j.best_val_acc)
    assert ts.train_seen == js.train_seen and ts.eval_seen == js.eval_seen
    assert [len(v) for v in ts.train_seen[:5]] == [10, 10, 10, 10, 6]


def test_steps_trainer_refuses_a_mesh(splits):
    with pytest.raises(NotImplementedError, match="item 8"):
        tloop.train_supervised_ae(
            splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
            alpha=35.0, lr=1e-3, device=CPU, mesh=object())


def _spy(monkeypatch, name):
    real, sizes = getattr(tsteps, name), []

    def wrapped(model, opt_or_x, *a, **kw):
        out = real(model, opt_or_x, *a, **kw)
        labels = a[1] if name.endswith("train_step") else a[0]
        sizes.append(len(labels))
        return out
    monkeypatch.setattr(tsteps, name, wrapped)
    return sizes


def test_steps_engine_sweeps_run(monkeypatch, splits, tmp_path):
    """Both sweeps with engine="steps": every step on the per-batch loop
    (the remainder batch of 6 kept, eval batches of 10 and 2), satae's store
    keys, finite losses, seeds seed + cfg_idx, and no in-flight files even
    with checkpoint_every (the steps engine keeps config-granular resume)."""
    train = _spy(monkeypatch, "ae_train_step")
    evals = _spy(monkeypatch, "ae_eval_step")
    ae_cfg = TC.AETrainConfig(alphas=(20.0,), learning_rates=(1e-3, 5e-3),
                              max_epochs=2, checkpoint_every=1)
    run = tmp_path / "run"
    sweep = tgrid.ae_grid_search(
        splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
        ae_cfg=ae_cfg, device=CPU, seed=3, out_dir=str(run), engine="steps")
    assert train == [10, 10, 10, 10, 10, 6] * 4
    assert evals == [10, 2] * 4
    store = json.loads((run / "validation_losses.json").read_text())
    assert list(store) == [json.dumps({"alpha": 20.0, "lr": lr})
                           for lr in (1e-3, 5e-3)]
    assert all(r["epochs_run"] == 2 and math.isfinite(r["best_val_loss"])
               for r in store.values())
    assert not (run / "inflight").exists()
    assert all(math.isfinite(v) for vs in sweep.best.history.values()
               for v in vs)
    mtrain = _spy(monkeypatch, "mlp_train_step")
    rng = np.random.default_rng(4)
    x = {n: rng.standard_normal((n, 8)).astype(np.float32) for n in (46, 13)}
    y = {n: rng.integers(0, 10, n).astype(np.int32) for n in (46, 13)}
    msweep = tgrid.mlp_grid_search(
        x[46], y[46], x[13], y[13], model_cfg=TCFG,
        mlp_cfg=TC.MLPTrainConfig(learning_rates=(1e-3, 1e-2), epochs=2),
        device=CPU, batch_size=B, seed=3, out_dir=str(run), engine="steps",
        test_x=x[13], test_y=y[13])
    assert mtrain == [10, 10, 10, 10, 6] * 4
    mstore = json.loads((run / "mlp_results.json").read_text())
    assert list(mstore) == [json.dumps({"lr": lr}) for lr in (1e-3, 1e-2)]
    assert all(set(r) == {"lr", "best_val_acc", "best_val_loss",
                          "best_epoch", "test_acc"} for r in mstore.values())
    assert msweep.best_hparams["lr"] in (1e-3, 1e-2)
    # the same trainer as the per-batch loop of one config, seeded 3 + 1
    again = tloop.train_mlp(x[46], y[46], x[13], y[13], model_cfg=TCFG,
                            lr=1e-2, device=CPU, epochs=2, batch_size=B,
                            seed=4)
    assert again.best_val_acc == mstore[json.dumps({"lr": 1e-2})][
        "best_val_acc"]
