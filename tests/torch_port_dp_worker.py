"""Rank bodies of the port's data-parallel tests, and :func:`run`, which
runs one of them on N ranks over Gloo on the CPU.

Each rank is a process started with ``spawn``, which imports this module
and nothing of the test module that called :func:`run`: this module imports
no JAX and nothing of the ``satae`` package, so a rank starts without
tests/conftest.py's 8-device JAX setup. A rank joins a process group of
Gloo over a file store in the test's tmp directory (no TCP port, so tests
running side by side never collide), sets two torch threads
(tests/torch_port_threads.py says why), reads its payload, runs the named
body and saves what it returns for the test to compare.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from satae_torch import config as TC  # noqa: E402
from satae_torch.api import SatAEPipeline  # noqa: E402
from satae_torch.data.pipeline import ArrayDataset  # noqa: E402
from satae_torch.models.supervised_ae import SupervisedAE  # noqa: E402
from satae_torch.parallel import make_grid_mesh, make_mesh  # noqa: E402
from satae_torch.parallel.dp import (  # noqa: E402
    make_dp_ae_eval_step, make_dp_ae_eval_step_weighted,
    make_dp_ae_train_step)
from satae_torch.train import fast_loop, loop  # noqa: E402
from satae_torch.train import shard_sweep  # noqa: E402
from satae_torch.train.extract import extract_features  # noqa: E402
from satae_torch.train.optim import adam_init  # noqa: E402

CPU = torch.device("cpu")
TIMEOUT_S = 240


def run(world: int, body: str, tmp_path, payload) -> list:
    """``body(payload)`` on ``world`` ranks; each rank's return value, in
    rank order. A rank that raises fails the call with its traceback."""
    tmp = Path(tmp_path) / f"ranks_{body}"
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / "payload.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, str(tmp), body))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp / f"error{r}.txt") for r in range(world)]
    found = [e.read_text() for e in errors if e.exists()]
    assert not found, "\n".join(found)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank(rank: int, world: int, tmp: str, body: str) -> None:
    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world)
        payload = torch.load(Path(tmp) / "payload.pt", weights_only=False)
        out = globals()[body](payload)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    except BaseException:
        Path(tmp, f"error{rank}.txt").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)
    dist.destroy_process_group()


def _floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _sd(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# -- bodies -------------------------------------------------------------------

def dp_ae_steps(p) -> dict:
    """AE train steps on this rank's rows of each global batch from the
    state_dict ``p["sd"]``: the draws given per step (sliced to this rank's
    rows) or, where a step has none, drawn from a generator seeded
    ``p["seed"]``. The metrics, the state before each step and after the
    last."""
    mesh = make_mesh(device="cpu")
    model = SupervisedAE(p["model_cfg"], 3, p["data_cfg"].image_size)
    model.load_state_dict(p["sd"])
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator().manual_seed(p["seed"])
    step = make_dp_ae_train_step(mesh, p["data_cfg"])
    out = {"metrics": [], "pre": []}
    for imgs, labels, draws in p["steps"]:
        out["pre"].append(_sd(model))
        kw = {k: mesh.shard(v) for k, v in (draws or {}).items()}
        m, _ = step(model, opt, mesh.shard(imgs), mesh.shard(labels),
                    p["alpha"], p["lr"], generator=gen, **kw)
        out["metrics"].append(_floats(m))
    out["final"] = _sd(model)
    return out


def dp_eval(p) -> dict:
    """The unweighted DP eval of the global batch ``p["images"]`` (its
    length a multiple of the world) on the state_dict ``p["sd"]``."""
    mesh = make_mesh(device="cpu")
    model = SupervisedAE(p["model_cfg"], 3, p["images"].shape[1])
    model.load_state_dict(p["sd"])
    return _floats(make_dp_ae_eval_step(mesh)(
        model, mesh.shard(p["images"]), mesh.shard(p["labels"]), p["alpha"]))


def dp_serving(p) -> dict:
    """The run directory ``p["run"]`` loaded into a pipeline over the
    world: the weighted DP eval of a batch padded with zero-weight rows,
    DP extraction, and encode / predict / predict_proba / decode /
    reconstruct."""
    world = dist.get_world_size()
    cfg = dataclasses.replace(p["cfg"], runtime=TC.RuntimeConfig(
        n_devices=world))
    pipe = SatAEPipeline(cfg, device="cpu").load(p["run"])
    mesh = make_mesh(world, device="cpu")
    imgs, labels = p["images"], p["labels"]
    pad = (-len(labels)) % world
    w = torch.cat([torch.ones(len(labels)), torch.zeros(pad)])
    x = torch.cat([imgs, torch.zeros((pad,) + imgs.shape[1:], dtype=imgs.dtype)])
    y = torch.cat([labels, torch.zeros(pad, dtype=labels.dtype)])
    sums = make_dp_ae_eval_step_weighted(mesh)(
        pipe.ae, mesh.shard(x), mesh.shard(y), mesh.shard(w), p["alpha"])
    ex = p["extract"]
    X, yx = extract_features(pipe.ae.enc, ArrayDataset(ex.numpy(), np.arange(
        len(ex), dtype=np.int32) % 10), p["batch_size"], mesh=mesh)
    u8 = imgs.numpy()
    z = pipe.encode(u8)
    return {"eval": _floats(sums), "extract": (X, yx), "encode": z,
            "predict": pipe.predict(u8), "proba": pipe.predict_proba(u8),
            "decode": pipe.decode(z), "reconstruct": pipe.reconstruct(u8)}


def dp_trainers(p) -> dict:
    """The DP scan-epoch trainer and the per-batch trainer on the splits
    ``p["train"]`` / ``p["val"]``: their results."""
    mesh = make_mesh(device="cpu")
    kw = dict(model_cfg=p["model_cfg"], data_cfg=p["data_cfg"],
              alpha=p["alpha"], lr=p["lr"], device=CPU,
              max_epochs=p["epochs"], patience=15, seed=0, mesh=mesh)
    scan = fast_loop.train_supervised_ae(p["train"], p["val"], **kw)
    steps = loop.train_supervised_ae(p["train"], p["val"], **kw)
    return {name: dict(best_val_loss=r.best_val_loss, best_epoch=r.best_epoch,
                       epochs_run=r.epochs_run, history=r.history,
                       state=r.state_dict())
            for name, r in (("scan", scan), ("steps", steps))}


def _sweep_record(sweep, out_dir) -> dict:
    files = {} if out_dir is None else {
        f.name: f.read_bytes() for f in sorted(Path(out_dir).iterdir())
        if f.is_file()}
    return dict(best_hparams=sweep.best_hparams, results=sweep.results,
                best_state=sweep.best.state_dict(),
                best=(sweep.best.best_val_loss, sweep.best.best_val_acc,
                      sweep.best.best_epoch, sweep.best.epochs_run,
                      sweep.best.history), files=files)


def sharded_sweeps(p) -> dict:
    """The sharded AE and MLP sweeps of ``p`` on a 1-D mesh over the world
    and on the 2-D mesh of one config x the world's data ranks, each into
    a run directory of its own (``p["runs"]``, per mesh)."""
    world = dist.get_world_size()
    out = {}
    for name, mesh in (("1d", make_mesh(device="cpu")),
                       ("2d", make_grid_mesh(1, world, device="cpu"))):
        run = Path(p["runs"]) / name
        ae = shard_sweep.ae_sharded_grid_search(
            p["train"], p["val"], model_cfg=p["model_cfg"],
            data_cfg=p["data_cfg"], ae_cfg=p["ae_cfg"], mesh=mesh,
            device=CPU, seed=p["seed"], out_dir=str(run / "ae"))
        mlp = shard_sweep.mlp_sharded_grid_search(
            *p["latents"], model_cfg=p["model_cfg"], mlp_cfg=p["mlp_cfg"],
            mesh=mesh, device=CPU, batch_size=p["data_cfg"].batch_size,
            seed=p["seed"], out_dir=str(run / "mlp"), test_x=p["test"][0],
            test_y=p["test"][1])
        dist.barrier()
        out[name] = {"ae": _sweep_record(ae, run / "ae"),
                     "mlp": _sweep_record(mlp, run / "mlp")}
    return out


def scripted_sweeps(p) -> dict:
    """The sharded sweeps on a 1-D mesh with the per-config trainers
    replaced by ``p["cases"]``'s scripted results (taken in seed order):
    each case's results, logs and run directory."""
    mesh = make_mesh(device="cpu")
    real = fast_loop.train_supervised_ae, fast_loop.train_mlp
    out = {}
    for name, case in p["cases"].items():
        results = case["results"]
        seeds = []

        def train(*a, seed, **kw):
            seeds.append(seed)
            return results[seed - p["seed"]]

        fast_loop.train_supervised_ae = fast_loop.train_mlp = train
        log = []
        run = case["run"]
        kw = dict(mesh=mesh, device=CPU, seed=p["seed"], log=log.append,
                  out_dir=run)
        if case["kind"] == "ae":
            sweep = shard_sweep.ae_sharded_grid_search(
                p["train"], p["val"], model_cfg=p["model_cfg"],
                data_cfg=p["data_cfg"], ae_cfg=p["ae_cfg"], **kw)
        else:
            sweep = shard_sweep.mlp_sharded_grid_search(
                *p["latents"], model_cfg=p["model_cfg"], mlp_cfg=p["mlp_cfg"],
                batch_size=p["data_cfg"].batch_size, **kw,
                **case.get("test", {}))
        dist.barrier()
        out[name] = dict(_sweep_record(sweep, run), log=log, seeds=seeds)
    fast_loop.train_supervised_ae, fast_loop.train_mlp = real
    return out


def many(p) -> dict:
    """Several bodies in one spawn: ``p`` maps a name to (body, payload)."""
    return {name: globals()[body](sub) for name, (body, sub) in p.items()}
