"""The port's config-sharded sweeps (satae_torch.train.shard_sweep) on two
ranks over Gloo on the CPU (tests/torch_port_dp_worker.py), at the tiny
config of tests/test_torch_port_grid.py (channels (4, 8), latent 8, 16x16
images, batch 8):

  * real training, 3 AE configs and 3 MLP lrs (a padded round on two ranks),
    on a 1-D mesh (one config per rank per round) against the port's
    sequential engine: every config trains alone on its rank with its
    sequential seed, so the results, the winner and the run directory's
    files are the sequential engine's bit for bit; on the 2-D mesh of one
    config x two data ranks (``grid_dp`` 2 on 2 ranks) each AE config trains
    data-parallel: per-config best val loss rel 1e-3 and best epoch equal
    for the configs that do not diverge, the same winner; the MLP ignores
    the data axis, bit for bit again (tests/test_parallel.py:168-260 hold
    satae's sharded sweeps the same ways);
  * the selection contract against satae's: the per-config trainers
    replaced by the same scripted results in both packages (the cases of
    tests/test_torch_port_grid.py: fresh, ties, resumes, all diverged,
    provenance and torn meta, no run directory), satae's sweep against the
    port's sharded one on two ranks: the same seeds, winner, results, log
    lines and run-directory bytes.

satae's sharded engine trains with JAX's random streams, the port with
torch's (satae_torch/data/augment.py), so trained losses are not compared
across the packages; the scripted cases hold the books, which is what the
sharding changes.
"""

import json
import math

import numpy as np
import pytest
import torch

from satae.train import fast_loop as jfast
from satae.train import gridsearch as jgrid
from torch_port_threads import two_threads  # noqa: F401 (autouse)
import torch_port_dp_worker as W
from satae_torch import config as TC
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.parallel import make_mesh
from satae_torch.train import gridsearch as tgrid
from satae_torch.train import shard_sweep
from test_torch_port_grid import (AE_CASES, JAE, JCFG, JDATA, JMLP,
                                  MLP_CASES, TAE, TCFG, TDATA, TMLP,
                                  _assert_same_winner, _prior, _scripted,
                                  _stub)

CPU = torch.device("cpu")
SEED = 7
REAL_AE = TC.AETrainConfig(alphas=(35.0,), learning_rates=(1e-3, 5e-3, 5e-1),
                           max_epochs=3, patience=2)
REAL_MLP = TC.MLPTrainConfig(learning_rates=(1e-5, 1e-3, 1e-2), epochs=3)


def _latents(seed=0):
    """Separable 8-dim latents (train 56, val 12, test 12), as
    tests/test_parallel.py's MLP sweep."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2, (10, 8)).astype(np.float32)
    out = []
    for n in (56, 12, 12):
        y = rng.integers(0, 10, n).astype(np.int32)
        out += [centers[y] + rng.normal(0, 0.3, (n, 8)).astype(np.float32), y]
    return out


def _scripted_xy():
    rng = np.random.default_rng(0)
    x = {n: rng.standard_normal((n, 8)).astype(np.float32) for n in (56, 12)}
    y = {n: rng.integers(0, 10, n).astype(np.int32) for n in (56, 12)}
    return x, y


@pytest.fixture(scope="module")
def splits():
    return make_splits(load_dataset(TDATA), TDATA)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, splits):
    """The port's sequential sweeps, and every two-rank sweep of this
    module in one spawn."""
    tmp = tmp_path_factory.mktemp("shard")
    xtr, ytr, xva, yva, xte, yte = _latents()
    seq = {}
    for kind in ("ae", "mlp"):
        run = tmp / "seq" / kind
        if kind == "ae":
            seq[kind] = tgrid.ae_grid_search(
                splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
                ae_cfg=REAL_AE, device=CPU, seed=SEED, out_dir=str(run))
        else:
            seq[kind] = tgrid.mlp_grid_search(
                xtr, ytr, xva, yva, model_cfg=TCFG, mlp_cfg=REAL_MLP,
                device=CPU, batch_size=TDATA.batch_size, seed=SEED,
                out_dir=str(run), test_x=xte, test_y=yte)
    x, y = _scripted_xy()
    cases = {}
    for kind, table in (("ae", AE_CASES), ("mlp", MLP_CASES)):
        for name, case in table.items():
            run = tmp / "scripted" / f"{kind}_{name}"
            run.mkdir(parents=True)
            if "prior" in case:
                _prior(kind, run, case["prior"])
            cached = case.get("prior", {}).get("cached", 0)
            tres = [t for _, t in _scripted(kind, case["metrics"])]
            test = dict(test_x=x[12][::-1].copy(), test_y=y[12][::-1].copy()) \
                if case.get("test") else {}
            cases[f"{kind}_{name}"] = dict(
                kind=kind, results={cached + i: r for i, r in
                                    enumerate(tres)}, test=test,
                run=str(run) if case.get("out_dir", True) else None)
    payload = {
        "real": ("sharded_sweeps", dict(
            train=splits.train, val=splits.val, model_cfg=TCFG,
            data_cfg=TDATA, ae_cfg=REAL_AE, mlp_cfg=REAL_MLP, seed=SEED,
            latents=(xtr, ytr, xva, yva), test=(xte, yte),
            runs=str(tmp / "sharded"))),
        "scripted": ("scripted_sweeps", dict(
            train=splits.train, val=splits.val, model_cfg=TCFG,
            data_cfg=TDATA, ae_cfg=TAE, mlp_cfg=TMLP, seed=SEED,
            latents=(x[56], y[56], x[12], y[12]), cases=cases)),
    }
    ranks = W.run(2, "many", tmp, payload)
    return dict(ranks=ranks, seq=seq, seq_dir=tmp / "seq")


def _files(run):
    return {f.name: f.read_bytes() for f in sorted(run.iterdir())
            if f.is_file()}


def test_both_ranks_keep_the_same_books(setup):
    r0, r1 = setup["ranks"]
    for part in ("real", "scripted"):
        for name in r0[part]:
            a, b = r0[part][name], r1[part][name]
            for kind in (("ae", "mlp") if part == "real" else (None,)):
                x, y = (a[kind], b[kind]) if kind else (a, b)
                assert x["best_hparams"] == y["best_hparams"]
                assert json.dumps(x["results"], sort_keys=True) == \
                    json.dumps(y["results"], sort_keys=True)
                assert x["files"] == y["files"]
                for k, v in x["best_state"].items():
                    assert torch.equal(v, y["best_state"][k]), (name, k)


@pytest.mark.parametrize("kind", ["ae", "mlp"])
def test_1d_sharded_sweep_is_the_sequential_sweep(setup, kind):
    """One config per rank per round (the second round padded): each config
    is the sequential engine's bit for bit, and so are the winner, its
    curves and the run directory."""
    ours = setup["ranks"][0]["real"]["1d"][kind]
    seq = setup["seq"][kind]
    assert ours["best_hparams"] == seq.best_hparams
    assert json.dumps(ours["results"], sort_keys=True) == json.dumps(
        seq.results, sort_keys=True)
    loss, acc, best_epoch, epochs_run, history = ours["best"]
    assert (loss, acc, best_epoch, epochs_run) == (
        seq.best.best_val_loss, seq.best.best_val_acc, seq.best.best_epoch,
        seq.best.epochs_run)
    assert history == seq.best.history
    for k, v in seq.best.state_dict().items():
        assert torch.equal(ours["best_state"][k], v), k
    assert ours["files"] == _files(setup["seq_dir"] / kind)


def test_2d_sharded_ae_sweep_trains_each_config_data_parallel(setup):
    """grid_dp 2 on 2 ranks: each AE config data-parallel over both ranks.
    Per-config best val loss rel 1e-3 and best epoch equal to the
    sequential engine's at the lrs that train (1e-3, 5e-3), the same winner.
    At lr 0.5 Adam is chaotic: its loss rises after the first epoch, and
    the rounding of a sum taken in another order, or by another number of
    threads, moves it by tens of percent; the 1-D case holds it bit for
    bit, here it is held finite."""
    ours = setup["ranks"][0]["real"]["2d"]["ae"]
    seq = setup["seq"]["ae"]
    assert ours["best_hparams"] == seq.best_hparams
    assert list(ours["results"]) == list(seq.results)
    for k, r in seq.results.items():
        a, b = r["best_val_loss"], ours["results"][k]["best_val_loss"]
        if r["lr"] < 0.1:
            assert b == pytest.approx(a, rel=1e-3), k
            assert ours["results"][k]["best_epoch"] == r["best_epoch"], k
        else:
            assert math.isfinite(b), k


def test_2d_sharded_mlp_sweep_ignores_the_data_axis(setup):
    ours = setup["ranks"][0]["real"]["2d"]["mlp"]
    seq = setup["seq"]["mlp"]
    assert json.dumps(ours["results"], sort_keys=True) == json.dumps(
        seq.results, sort_keys=True)
    assert ours["files"] == _files(setup["seq_dir"] / "mlp")


def test_sharded_sweeps_refuse_a_train_set_below_one_batch(splits):
    """satae's refusal, before any collective (a mesh of one rank here)."""
    tiny = type(splits.train)(splits.train.images[:4], splits.train.labels[:4])
    x = np.zeros((4, 8), np.float32)
    y = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="smaller than batch_size"):
        shard_sweep.ae_sharded_grid_search(
            tiny, splits.val, model_cfg=TCFG, data_cfg=TDATA, ae_cfg=REAL_AE,
            mesh=None, device=CPU)
    with pytest.raises(ValueError, match="smaller than batch_size"):
        shard_sweep.mlp_sharded_grid_search(
            x, y, x, y, model_cfg=TCFG, mlp_cfg=REAL_MLP, mesh=None,
            device=CPU, batch_size=8)


def test_sharded_mlp_sweep_without_a_snapshot_takes_the_fallback(tmp_path):
    """No lr keeps a best-epoch snapshot (0 epochs): the sweep returns the
    all-diverged fallback and checkpoints it with the ``diverged`` marker,
    as satae's (tests/test_parallel.py:238); on a mesh of one rank."""
    import torch.distributed as dist

    xtr, ytr, xva, yva, _, _ = _latents()
    try:
        sweep = shard_sweep.mlp_sharded_grid_search(
            xtr, ytr, xva, yva, model_cfg=TCFG,
            mlp_cfg=TC.MLPTrainConfig(learning_rates=(1e-3, 1e-2), epochs=0),
            mesh=make_mesh(1, device="cpu"), device=CPU, batch_size=8,
            out_dir=str(tmp_path))
    finally:
        dist.destroy_process_group()
    assert sweep.best is not None
    meta = json.loads((tmp_path / "mlp_global_best.json").read_text())
    assert meta.get("diverged") is True


def _satae_scripted(kind, case, run, monkeypatch, splits):
    """satae's sequential sweep with its trainers scripted as
    tests/test_torch_port_grid.py's _run_both scripts them."""
    jres = [j for j, _ in _scripted(kind, case["metrics"])]
    seeds, log = [], []
    use_dir = case.get("out_dir", True)
    if use_dir and "prior" in case:
        _prior(kind, run, case["prior"])
    if kind == "ae":
        monkeypatch.setattr(jfast, "AEScanEngine", lambda *a, **k: None)
        monkeypatch.setattr(jfast, "upload_ae_data", lambda *a, **k: None)
        monkeypatch.setattr(jfast, "train_supervised_ae_scan",
                            _stub(jres, seeds))
        res = jgrid.ae_grid_search(
            splits.train, splits.val, model_cfg=JCFG, data_cfg=JDATA,
            ae_cfg=JAE, seed=SEED, log=log.append,
            out_dir=str(run) if use_dir else None)
    else:
        x, y = _scripted_xy()
        test = dict(test_x=x[12][::-1].copy(), test_y=y[12][::-1].copy()) \
            if case.get("test") else {}
        monkeypatch.setattr(jfast, "MLPScanEngine", lambda *a, **k: None)
        monkeypatch.setattr(jfast, "upload_mlp_data", lambda *a, **k: None)
        monkeypatch.setattr(jfast, "train_mlp_scan", _stub(jres, seeds))
        res = jgrid.mlp_grid_search(
            x[56], y[56], x[12], y[12], model_cfg=JCFG, mlp_cfg=JMLP,
            batch_size=TDATA.batch_size, seed=SEED, log=log.append,
            out_dir=str(run) if use_dir else None, **test)
    return res, seeds, log


@pytest.mark.parametrize("case", [f"ae_{c}" for c in sorted(AE_CASES)]
                         + [f"mlp_{c}" for c in sorted(MLP_CASES)])
def test_sharded_sweep_selects_as_satae(setup, case, tmp_path, monkeypatch,
                                        splits):
    kind, name = case.split("_", 1)
    table = AE_CASES if kind == "ae" else MLP_CASES
    run = tmp_path / "satae"
    run.mkdir()
    j, jseeds, jlog = _satae_scripted(kind, table[name], run, monkeypatch,
                                      splits)
    r0, r1 = (r["scripted"][case] for r in setup["ranks"])
    assert sorted(r0["seeds"] + r1["seeds"]) == jseeds
    assert r0["log"] == r1["log"] == jlog
    assert r0["best_hparams"] == j.best_hparams
    assert json.dumps(r0["results"], sort_keys=True) == json.dumps(
        j.results, sort_keys=True)

    class Best:  # the rank's winner, as _assert_same_winner reads one
        pass
    best = Best()
    best.state_dict = lambda: r0["best_state"]
    (best.best_val_loss, best.best_val_acc, best.best_epoch, _,
     _) = r0["best"]
    _assert_same_winner(kind, j.best, best)
    if table[name].get("out_dir", True):
        assert r0["files"] == _files(run)
