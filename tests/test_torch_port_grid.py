"""The port's grid sweeps against satae's: the selection contract with the
trainers replaced by the same scripted results in both packages (the cases
of tests/test_sweep_common.py and test_sweepbook_ignores_provenance_meta,
run through ``ae_grid_search`` / ``mlp_grid_search`` end to end), and the
port's ``fit(grid=True, out_dir=...)`` at the tiny config of
tests/test_torch_port_fit.py on the CPU (a 2x2 AE grid, 2 MLP lrs, 2 epochs
each): artifacts, resume without training, refusals.

Every comparison with satae here is exact: both packages get the same
scripted weights and metrics, so the stores, sidecars and checkpoints must
be the same bytes, the logs the same lines and the seeds the same numbers.
That holds for the one number both compute, an lr's test accuracy, too:
satae averages per-batch means, the port divides the count once, and with
batches of 8 and 4 both are exact.
"""

import dataclasses
import json
import math
import shutil

import jax
import numpy as np
import pytest
import torch

from satae import config as JC
from satae.io.checkpoint import GridResultStore as JaxStore
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from satae.train import fast_loop as jfast
from satae.train import gridsearch as jgrid
from satae.train.loop import TrainResult as JaxResult
from satae.train.sweep_common import save_best_checkpoint as jax_save_best
from satae.io.torch_export import (mlp_to_torch_state_dict,
                                   sae_to_torch_state_dict)
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.api import SatAEPipeline
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.io import convert
from satae_torch.io.checkpoint import GridResultStore, load_grid_results
from satae_torch.train import fast_loop as tfast
from satae_torch.train import gridsearch as tgrid
from satae_torch.train import loop as tloop
from satae_torch.train.loop import TrainResult
from test_torch_port_models import numpy_trees

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, B = 16, 8
TDATA = TC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
JDATA = JC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
ALPHAS, AE_LRS, MLP_LRS = (20.0, 35.0), (1e-3, 5e-3), (1e-3, 1e-2)
TAE = TC.AETrainConfig(alphas=ALPHAS, learning_rates=AE_LRS, max_epochs=2)
JAE = JC.AETrainConfig(alphas=ALPHAS, learning_rates=AE_LRS, max_epochs=2)
TMLP = TC.MLPTrainConfig(learning_rates=MLP_LRS, epochs=2)
JMLP = JC.MLPTrainConfig(learning_rates=MLP_LRS, epochs=2)
CFG = TC.PipelineConfig(data=TDATA, model=TCFG, ae=TAE, mlp=TMLP)
NAN, INF = float("nan"), float("inf")


@pytest.fixture(scope="module")
def splits():
    return make_splits(load_dataset(TDATA), TDATA)


# -- scripted sweeps ---------------------------------------------------------

def _trees(kind, tag):
    if kind == "ae":
        return numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=tag)
    return numpy_trees(mlp_init, JCFG, seed=tag)


def _port_sd(kind, trees):
    sd = (sae_to_torch_state_dict(*trees, JCFG, image_size=IMG)
          if kind == "ae" else mlp_to_torch_state_dict(*trees, JCFG))
    return convert.to_tensors(sd)


def _scripted(kind, metrics):
    """The same results for both packages: satae's trees and the port's
    state_dicts of them, with the selection metric ``metrics[i]`` (loss for
    the AE, accuracy for the MLP) and a distinct other metric."""
    out = []
    for i, m in enumerate(metrics):
        trees = _trees(kind, 10 + i)
        loss, acc = (m, 0.25 + 0.01 * i) if kind == "ae" else \
            (1.0 + 0.1 * i, m)
        out.append((JaxResult(*trees, loss, acc, 3, 5, {}),
                    TrainResult(_port_sd(kind, trees), {}, loss, acc, 3, 5,
                                {})))
    return out


def _stub(results, seeds):
    it = iter(results)

    def train(*args, seed, **kw):
        seeds.append(seed)
        return next(it)
    return train


def _prior(kind, run, prior):
    """An earlier run's state, written by satae: the first ``cached``
    configs in the store and its winner (the first of them, tag 99)
    checkpointed; or only a given meta sidecar."""
    if "meta" in prior:
        (run / f"{kind}_global_best.json").write_text(prior["meta"])
        return
    if kind == "ae":
        hps = [{"alpha": a, "lr": lr} for a in ALPHAS for lr in AE_LRS]
        name, store = "ae_global_best", "validation_losses.json"
    else:
        hps = [{"lr": lr} for lr in MLP_LRS]
        name, store = "mlp_global_best", "mlp_results.json"
    sign = 1.0 if kind == "ae" else -1.0
    for i, hp in enumerate(hps[:prior["cached"]]):
        metric = prior["metric"] + sign * 0.5 * i
        res = _scripted(kind, [metric])[0][0]
        JaxStore(run / store).record(JaxStore.key(**hp), {
            **hp, "best_val_loss": res.best_val_loss,
            "best_val_acc": res.best_val_acc, "best_epoch": 3})
    winner = JaxResult(*_trees(kind, 99), *(
        (prior["metric"], 0.5) if kind == "ae" else (0.9, prior["metric"])),
        4, 6, {})
    jax_save_best(str(run), name, winner.params, winner.bn_state, hps[0],
                  winner)


AE_CASES = {
    "fresh": dict(metrics=[1.0, 2.0, 0.5, 0.7]),
    "first_wins_ties": dict(metrics=[0.5, 0.5, 0.5, 0.6]),
    "resume_checkpoint_wins": dict(prior=dict(metric=0.4, cached=2),
                                   metrics=[0.6, 0.45]),
    "resume_fresh_wins": dict(prior=dict(metric=0.4, cached=2),
                              metrics=[0.6, 0.3]),
    "resume_all_cached": dict(prior=dict(metric=0.4, cached=4), metrics=[]),
    "all_diverged": dict(metrics=[NAN, INF, NAN, INF]),
    "provenance_meta_ignored": dict(prior=dict(meta='{"reused": true}'),
                                    metrics=[INF, NAN, INF, NAN]),
    "torn_meta_ignored": dict(prior=dict(meta='{"alpha": 2'),
                              metrics=[1.0, 0.9, 1.1, 1.2]),
    "no_out_dir": dict(metrics=[1.0, 0.8, 0.9, 1.5], out_dir=False),
}
MLP_CASES = {
    "fresh_max_with_test_acc": dict(metrics=[0.7, 0.6], test=True),
    "resume_checkpoint_wins_max": dict(prior=dict(metric=0.7, cached=1),
                                       metrics=[0.65]),
    "resume_fresh_wins_max": dict(prior=dict(metric=0.7, cached=1),
                                  metrics=[0.75]),
    "all_nan_max": dict(metrics=[NAN, NAN]),
    "finite_beats_nan": dict(metrics=[NAN, 0.1]),
    "provenance_meta_ignored_max": dict(prior=dict(meta='{"reused": true}'),
                                        metrics=[NAN, 0.2]),
}


def _assert_same_run_dir(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _assert_same_winner(kind, jbest, tbest):
    ours = (convert.sae_from_torch_state_dict(tbest.state_dict(), TCFG,
                                              image_size=IMG)
            if kind == "ae" else
            convert.mlp_from_torch_state_dict(tbest.state_dict(), TCFG))
    jax.tree_util.tree_map(np.testing.assert_array_equal, ours,
                           (jbest.params, jbest.bn_state))
    for f in ("best_val_loss", "best_val_acc", "best_epoch"):
        a, b = getattr(tbest, f), getattr(jbest, f)
        assert a == b or (math.isnan(a) and math.isnan(b)), f


def _run_both(kind, case, tmp_path, monkeypatch, splits, engine="scan"):
    use_dir = case.get("out_dir", True)
    runs = {}
    for pkg in ("satae", "port"):
        run = tmp_path / pkg
        run.mkdir()
        if "prior" in case:
            _prior(kind, run, case["prior"])
        runs[pkg] = run
    jres, tres = zip(*_scripted(kind, case["metrics"])) if case["metrics"] \
        else ((), ())
    jseeds, tseeds, jlog, tlog = [], [], [], []
    if kind == "ae":
        if engine == "scan":
            monkeypatch.setattr(jfast, "AEScanEngine", lambda *a, **k: None)
            monkeypatch.setattr(jfast, "upload_ae_data", lambda *a, **k: None)
            monkeypatch.setattr(jfast, "train_supervised_ae_scan",
                                _stub(jres, jseeds))
            monkeypatch.setattr(tfast, "train_supervised_ae",
                                _stub(tres, tseeds))
        else:
            monkeypatch.setattr(jgrid, "train_supervised_ae",
                                _stub(jres, jseeds))
            monkeypatch.setattr(tloop, "train_supervised_ae",
                                _stub(tres, tseeds))
        j = jgrid.ae_grid_search(
            splits.train, splits.val, model_cfg=JCFG, data_cfg=JDATA,
            ae_cfg=JAE, seed=7, log=jlog.append, engine=engine,
            out_dir=str(runs["satae"]) if use_dir else None)
        t = tgrid.ae_grid_search(
            splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
            ae_cfg=TAE, device=torch.device("cpu"), seed=7, log=tlog.append,
            engine=engine, out_dir=str(runs["port"]) if use_dir else None)
    else:
        rng = np.random.default_rng(0)
        x = {n: rng.standard_normal((n, 8)).astype(np.float32)
             for n in (56, 12)}
        y = {n: rng.integers(0, 10, n).astype(np.int32) for n in (56, 12)}
        test = dict(test_x=x[12][::-1].copy(), test_y=y[12][::-1].copy()) \
            if case.get("test") else {}
        if engine == "scan":
            monkeypatch.setattr(jfast, "MLPScanEngine", lambda *a, **k: None)
            monkeypatch.setattr(jfast, "upload_mlp_data",
                                lambda *a, **k: None)
            monkeypatch.setattr(jfast, "train_mlp_scan", _stub(jres, jseeds))
            monkeypatch.setattr(tfast, "train_mlp", _stub(tres, tseeds))
        else:
            monkeypatch.setattr(jgrid, "train_mlp", _stub(jres, jseeds))
            monkeypatch.setattr(tloop, "train_mlp", _stub(tres, tseeds))
        j = jgrid.mlp_grid_search(
            x[56], y[56], x[12], y[12], model_cfg=JCFG, mlp_cfg=JMLP,
            batch_size=B, seed=7, log=jlog.append, engine=engine,
            out_dir=str(runs["satae"]) if use_dir else None, **test)
        t = tgrid.mlp_grid_search(
            x[56], y[56], x[12], y[12], model_cfg=TCFG, mlp_cfg=TMLP,
            device=torch.device("cpu"), batch_size=B, seed=7,
            log=tlog.append, engine=engine,
            out_dir=str(runs["port"]) if use_dir else None, **test)
    assert t.best_hparams == j.best_hparams
    assert tseeds == jseeds
    assert tlog == jlog
    assert json.dumps(t.results, sort_keys=True) == json.dumps(
        j.results, sort_keys=True)
    _assert_same_winner(kind, j.best, t.best)
    if use_dir:
        _assert_same_run_dir(runs["satae"], runs["port"])
    return j, t


@pytest.mark.parametrize("case", sorted(AE_CASES))
def test_ae_sweep_selects_as_satae(case, tmp_path, monkeypatch, splits):
    _, t = _run_both("ae", AE_CASES[case], tmp_path, monkeypatch, splits)
    if case.startswith(("all_diverged", "provenance")):
        meta = json.loads((tmp_path / "port" / "ae_global_best.json")
                          .read_text())
        assert meta["diverged"] is True
    if case == "resume_checkpoint_wins":
        assert t.best.epochs_run == 0  # read back from the checkpoint


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_sweep_selects_as_satae(case, tmp_path, monkeypatch, splits):
    _run_both("mlp", MLP_CASES[case], tmp_path, monkeypatch, splits)


def test_steps_engine_selects_as_satae(splits, tmp_path, monkeypatch):
    """satae's per-batch engine (engine="steps", refused until it was
    ported) dispatches to the per-batch trainers with the seeds, selection,
    stores and checkpoints of satae's; in-flight resume stays the scan
    engine's, which runs it and leaves no files."""
    for kind, case in (("ae", AE_CASES["resume_fresh_wins"]),
                       ("mlp", MLP_CASES["fresh_max_with_test_acc"])):
        (tmp_path / kind).mkdir()
        _run_both(kind, case, tmp_path / kind, monkeypatch, splits,
                  engine="steps")
    kw = dict(model_cfg=TCFG, device=torch.device("cpu"))
    out = tmp_path / "run"
    sweep = tgrid.ae_grid_search(
        splits.train, splits.val, data_cfg=TDATA, out_dir=str(out),
        ae_cfg=dataclasses.replace(TAE, checkpoint_every=1), **kw)
    assert len(sweep.results) == len(TAE.alphas) * len(TAE.learning_rates)
    assert not list((out / "inflight").iterdir())


# -- the port's grid fit end to end --------------------------------------------

def test_grid_fit_writes_and_resumes_a_run_dir(tmp_path, monkeypatch, splits):
    run = tmp_path / "run"
    lines = []
    pipe = SatAEPipeline(CFG, device="cpu")
    summary = pipe.fit(grid=True, out_dir=str(run), log=lines.append)
    assert sorted(p.name for p in run.iterdir()) == sorted([
        "ae_global_best.json", "ae_global_best.msgpack", "classes.json",
        "fit_summary.json", "mlp_global_best.json", "mlp_global_best.msgpack",
        "mlp_provenance.json", "mlp_results.json", "validation_losses.json",
        "ae_best_curves.png", "mlp_best_curves.png"])
    ae_store = load_grid_results(run / "validation_losses.json")
    mlp_store = load_grid_results(run / "mlp_results.json")
    assert list(ae_store) == [JaxStore.key(alpha=a, lr=lr)
                              for a in ALPHAS for lr in AE_LRS]
    assert list(mlp_store) == [JaxStore.key(lr=lr) for lr in MLP_LRS]
    assert all(0.0 <= r["test_acc"] <= 1.0 for r in mlp_store.values())
    assert [ln.split(":")[0] for ln in lines] == [
        f"alpha={a} lr={lr}" for a in ALPHAS for lr in AE_LRS] + [
        f"lr={lr}" for lr in MLP_LRS]
    best_key = GridResultStore.key(**summary.ae_hparams)
    assert summary.ae_val_loss == min(
        r["best_val_loss"] for r in ae_store.values())
    assert ae_store[best_key]["best_val_loss"] == summary.ae_val_loss
    assert mlp_store[GridResultStore.key(**summary.mlp_hparams)][
        "best_val_acc"] == summary.mlp_val_acc
    assert json.loads((run / "fit_summary.json").read_text())[
        "test_acc"] == summary.test_acc
    preds = pipe.predict(splits.test.images)
    assert summary.test_acc == float((preds == splits.test.labels).mean())

    # a second fit on the same directory trains nothing
    def refuse(*a, **k):
        raise AssertionError("a cached config was trained again")
    monkeypatch.setattr(tfast, "train_supervised_ae", refuse)
    monkeypatch.setattr(tfast, "train_mlp", refuse)
    lines.clear()
    again = SatAEPipeline(CFG, device="cpu")
    summary2 = again.fit(grid=True, out_dir=str(run), log=lines.append)
    assert all(ln.startswith("skip cached") for ln in lines) \
        and len(lines) == 6
    for f in ("ae_val_loss", "ae_hparams", "mlp_val_acc", "mlp_hparams",
              "test_acc"):
        assert getattr(summary2, f) == getattr(summary, f), f
    np.testing.assert_array_equal(again.predict(splits.test.images), preds)
    for a, b in ((pipe.ae, again.ae), (pipe.mlp, again.mlp)):
        for k, v in a.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, b.state_dict()[k]), k


def test_grid_fit_without_out_dir_and_reuse_ae(tmp_path, splits):
    pipe = SatAEPipeline(CFG, device="cpu")
    summary = pipe.fit(grid=True)
    assert set(summary.ae_hparams) == {"alpha", "lr"}
    assert summary.mlp_hparams["lr"] in MLP_LRS
    pipe.save(str(tmp_path / "src"))
    reuse = SatAEPipeline(CFG, device="cpu").load_ae(str(tmp_path / "src"))
    s2 = reuse.fit(grid=True, reuse_ae=True, out_dir=str(tmp_path / "dst"))
    assert s2.ae_hparams == {"reused": True} and s2.ae_val_loss is None
    assert not (tmp_path / "dst" / "validation_losses.json").exists()
    assert json.loads((tmp_path / "dst" / "ae_global_best.json")
                      .read_text()) == {"reused": True}
    np.testing.assert_array_equal(
        SatAEPipeline(CFG, device="cpu").load(str(tmp_path / "dst"))
        .predict(splits.test.images), reuse.predict(splits.test.images))
    shutil.rmtree(tmp_path / "dst")


def test_fit_trains_with_deterministic_cudnn_and_tf32_off(monkeypatch):
    """Every config of a grid fit trains with cuDNN's deterministic
    algorithms and TF32 off (on the card that makes a fit repeat bit for
    bit); the caller's settings come back afterwards."""
    seen = []
    real = tfast.train_supervised_ae

    def spy(*args, **kw):
        cudnn = torch.backends.cudnn
        seen.append((cudnn.deterministic, cudnn.allow_tf32))
        return real(*args, **kw)
    monkeypatch.setattr(tfast, "train_supervised_ae", spy)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32)
    SatAEPipeline(CFG, device="cpu").fit(grid=True)
    assert seen == [(True, False)] * len(ALPHAS) * len(AE_LRS)
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32) == before
