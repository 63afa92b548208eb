"""Config-batched hyperparameter sweeps: the counterpart of
satae/train/vmap_sweep.py, which trains every grid config at once.

satae gives parameters, optimizer state, BatchNorm state, alpha and lr a
leading config axis and ``jax.vmap``s one scan-epoch program over it. The
port does the same with an explicit axis: a satae_torch.models.stacked
model (grouped convolutions, per-config BatchNorm, every linear layer on
the batched K1 on the card), Adam with a per-config lr, and one eager epoch
loop (satae_torch.train.hbm's ``stacked_*`` bodies) over the shared batch
order ``epoch_order(n, B, seed, epoch)``; the augmentation draws and
dropout masks come from one device generator seeded ``seed + 1``, a slice
per config. Config i starts from the sequential engine's init of its seed
``seed + i`` (satae_torch.models.stacked).

The host side is satae's line for line: per-config early stopping
(patience on best val loss; a stopped config keeps computing but stops
counting), the global-best snapshot of config i taken at its own best
epoch, the least-bad fallback when no config ever improved, curves cut at
each config's stop, the winner checkpoint written before the per-config
store flush, store keys from the original Python floats (so a sequential
run on the same directory finds them), the MLP's per-lr best snapshots and
per-lr test accuracy at each lr's best epoch, and the same log lines.
``compute_dtype`` is satae's recipe for the AE (float32 master state); the
MLP sweep is float32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                ModelConfig)
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.io import convert
from satae_torch.io.checkpoint import GridResultStore
from satae_torch.models.mlp import MLP
from satae_torch.models.stacked import StackedMLP, StackedSupervisedAE
from satae_torch.train import fast_loop, hbm
from satae_torch.train.gridsearch import SweepResult
from satae_torch.train.loop import LogFn, TrainResult
from satae_torch.train.optim import adam_init
from satae_torch.train.sweep_common import _BUFFERS, save_best_checkpoint


def _slice(model, i: int):
    """Config i's (params, buffers) by reference name, host copies."""
    sd = model.config(i)
    is_buf = lambda k: k.rsplit(".", 1)[-1] in _BUFFERS
    return ({k: v.cpu() for k, v in sd.items() if not is_buf(k)},
            {k: v.cpu() for k, v in sd.items() if is_buf(k)})


def _host(sums: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device -> host read of an epoch's (C,) sums, as float32 numpy
    (satae's jax.device_get of its vmapped sums)."""
    return {k: v.cpu().numpy().astype(np.float32) for k, v in sums.items()}


def ae_vmap_grid_search(
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    *,
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    ae_cfg: AETrainConfig,
    device: torch.device,
    seed: int = 0,
    out_dir: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    log: Optional[LogFn] = None,
    save_curves: bool = False,
) -> SweepResult:
    # the original Python floats for result keys, so that a sweep resumed
    # by the sequential engine finds the same GridResultStore keys
    hparams = [(float(a), float(lr)) for a in ae_cfg.alphas
               for lr in ae_cfg.learning_rates]
    alphas = np.array([a for a, _ in hparams], np.float32)
    lrs = np.array([lr for _, lr in hparams], np.float32)
    n_cfg = len(alphas)

    fast_loop._check_full_batch(len(train_ds), data_cfg.batch_size,
                                "train split")
    model = StackedSupervisedAE(model_cfg, n_cfg, data_cfg.channels,
                                data_cfg.image_size).init_configs(seed)
    model.to(device)
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    images, labels, val_imgs, val_labs, val_wts = fast_loop.upload_ae_data(
        train_ds, val_ds, data_cfg.batch_size, device)
    alphas_d = torch.from_numpy(alphas).to(device)
    lrs_d = torch.from_numpy(lrs).to(device)

    # per-epoch (n_cfg,) metric arrays -> per-config train/val curves
    hist_keys = ("loss", "mse", "ce", "acc")
    metric_hist: Dict[str, list] = {f"{p}_{k}": []
                                    for p in ("train", "val")
                                    for k in hist_keys}
    n_train_counted = (len(train_ds) // data_cfg.batch_size) \
        * data_cfg.batch_size
    best_val = np.full((n_cfg,), np.inf, np.float64)
    best_acc = np.zeros((n_cfg,), np.float64)
    best_epoch = np.full((n_cfg,), -1, np.int64)
    bad_epochs = np.zeros((n_cfg,), np.int64)
    active = np.ones((n_cfg,), bool)
    stopped_at = np.full((n_cfg,), ae_cfg.max_epochs, np.int64)
    global_best = np.inf
    global_best_idx = -1
    best_snapshot = None

    epoch = 0
    for epoch in range(ae_cfg.max_epochs):
        order = hbm.epoch_order(len(train_ds), data_cfg.batch_size, seed,
                                epoch)
        tsum = _host(hbm.stacked_ae_train_epoch(
            model, opt, images, labels, order, alphas_d, lrs_d, data_cfg,
            gen, compute_dtype))
        vsum = _host(hbm.stacked_ae_eval_sums(model, val_imgs, val_labs,
                                              val_wts, alphas_d,
                                              compute_dtype))
        for k in hist_keys:
            metric_hist[f"train_{k}"].append(tsum[k] / n_train_counted)
            metric_hist[f"val_{k}"].append(vsum[k] / vsum["n"])
        val_loss = vsum["loss"] / vsum["n"]
        val_acc = vsum["acc"] / vsum["n"]

        improved = active & (val_loss < best_val)
        best_val = np.where(improved, val_loss, best_val)
        best_acc = np.where(improved, val_acc, best_acc)
        best_epoch = np.where(improved, epoch, best_epoch)
        bad_epochs = np.where(improved, 0, bad_epochs + 1)
        newly_stopped = active & (bad_epochs >= ae_cfg.patience)
        stopped_at = np.where(newly_stopped, epoch + 1, stopped_at)
        active &= ~newly_stopped

        # global-best snapshot (true best-epoch weights of the best config)
        epoch_best = int(np.argmin(np.where(improved, val_loss, np.inf)))
        if improved.any() and val_loss[epoch_best] < global_best:
            global_best = float(val_loss[epoch_best])
            global_best_idx = epoch_best
            best_snapshot = _slice(model, epoch_best)
        if log:
            hp = (f"(alpha={alphas[global_best_idx]}, "
                  f"lr={lrs[global_best_idx]})") if global_best_idx >= 0 \
                else "(none yet)"
            log(f"epoch {epoch:3d}: active={int(active.sum())}/{n_cfg} "
                f"global_best={global_best:.4f} {hp}")
        if not active.any():
            break

    if best_snapshot is None:
        # no config ever improved on +inf (e.g. NaN losses from epoch 0):
        # the end-of-run weights of the least-bad config, as the sequential
        # path degrades
        global_best_idx = int(np.argmin(np.nan_to_num(best_val, nan=np.inf)))
        best_snapshot = _slice(model, global_best_idx)
        global_best = float(best_val[global_best_idx])
    params, bn_state = best_snapshot
    best_hp = {"alpha": hparams[global_best_idx][0],
               "lr": hparams[global_best_idx][1]}
    gi = global_best_idx

    def cfg_history(i: int) -> Dict[str, list]:
        # a config's curves end at its own early stop: stopped configs keep
        # training, but those epochs never counted
        n_hist = int(min(stopped_at[i], len(metric_hist["val_loss"])))
        return {k: [float(v[i]) for v in metric_hist[k][:n_hist]]
                for k in metric_hist}

    history = cfg_history(gi)
    if save_curves and out_dir:
        from satae_torch.eval import plots
        for i in range(n_cfg):
            a, lr = hparams[i]
            plots.loss_curves(
                cfg_history(i),
                Path(out_dir) / "curves" / f"ae_alpha{a:g}_lr{lr:g}.png",
                title=f"AE alpha={a:g} lr={lr:g}")
    best = TrainResult(params, bn_state, global_best,
                       float(best_acc[gi]), int(best_epoch[gi]), epoch + 1,
                       history)
    if out_dir:
        save_best_checkpoint(
            out_dir, "ae_global_best", *convert.sae_from_torch_state_dict(
                best.state_dict(), model_cfg, data_cfg.channels,
                data_cfg.image_size), best_hp, best,
            diverged=not np.isfinite(global_best))

    # per-config records flush after the winner checkpoint: a crash between
    # the two must never leave store-cached configs whose winner weights
    # were not written (a sequential resume would then select a worse model)
    results: Dict[str, Dict[str, float]] = {}
    store = GridResultStore(Path(out_dir) / "validation_losses.json") \
        if out_dir else None
    for i in range(n_cfg):
        key = GridResultStore.key(alpha=hparams[i][0], lr=hparams[i][1])
        summary = {"alpha": hparams[i][0], "lr": hparams[i][1],
                   "best_val_loss": float(best_val[i]),
                   "best_val_acc": float(best_acc[i]),
                   "best_epoch": int(best_epoch[i]),
                   "epochs_run": int(min(stopped_at[i], epoch + 1))}
        results[key] = summary
        if store is not None:
            store.record(key, summary)
    return SweepResult(best, best_hp, results)


def mlp_vmap_grid_search(
    train_x: np.ndarray, train_y: np.ndarray,
    val_x: np.ndarray, val_y: np.ndarray,
    *,
    model_cfg: ModelConfig,
    mlp_cfg: MLPTrainConfig,
    device: torch.device,
    batch_size: int = 64,
    seed: int = 0,
    out_dir: Optional[str] = None,
    log: Optional[LogFn] = None,
    test_x: Optional[np.ndarray] = None,
    test_y: Optional[np.ndarray] = None,
    save_curves: bool = False,
) -> SweepResult:
    """Every lr of ``mlp_cfg`` at once for ``mlp_cfg.epochs``; each lr's
    best epoch by val accuracy, the global best over lrs."""
    lrs_py = [float(lr) for lr in mlp_cfg.learning_rates]  # key-stable floats
    lrs = np.asarray(lrs_py, np.float32)
    n_cfg = len(lrs)
    input_dim = train_x.shape[-1]

    fast_loop._check_full_batch(len(train_y), batch_size, "train set")
    model = StackedMLP(model_cfg, n_cfg, input_dim).init_configs(seed)
    model.to(device)
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    xs, ys, vx, vy, vw = fast_loop.upload_mlp_data(
        train_x, train_y, val_x, val_y, batch_size, device)
    lrs_d = torch.from_numpy(lrs).to(device)

    best_acc = np.full((n_cfg,), -1.0)
    best_loss = np.full((n_cfg,), np.inf)
    best_epoch = np.full((n_cfg,), -1, np.int64)
    snapshots: Dict[int, Any] = {}
    n_counted = (len(train_y) // batch_size) * batch_size
    metric_hist: Dict[str, list] = {k: [] for k in (
        "train_loss", "train_acc", "val_loss", "val_acc")}

    for epoch in range(mlp_cfg.epochs):
        order = hbm.epoch_order(len(train_y), batch_size, seed, epoch)
        tsum = _host(hbm.stacked_mlp_train_epoch(
            model, opt, xs, ys, order, lrs_d, mlp_cfg.weight_decay, gen))
        m = _host(hbm.stacked_mlp_eval_sums(model, vx, vy, vw))
        val_acc = m["acc"] / m["n"]
        val_loss = m["loss"] / m["n"]
        metric_hist["train_loss"].append(tsum["loss"] / n_counted)
        metric_hist["train_acc"].append(tsum["acc"] / n_counted)
        metric_hist["val_loss"].append(val_loss)
        metric_hist["val_acc"].append(val_acc)
        for i in np.flatnonzero(val_acc > best_acc):
            best_acc[i] = val_acc[i]
            best_loss[i] = val_loss[i]
            best_epoch[i] = epoch
            snapshots[i] = _slice(model, i)
        if log:
            log(f"epoch {epoch:3d}: best_val_acc={best_acc.max():.4f} "
                f"(lr={lrs[int(np.argmax(best_acc))]})")

    gi = int(np.argmax(best_acc))

    def cfg_history(i: int) -> Dict[str, list]:
        return {k: [float(v[i]) for v in metric_hist[k]]
                for k in metric_hist}

    # the winner checkpoint first, the per-config store flushes after
    params, bn_state = snapshots[gi]
    best_hp = {"lr": lrs_py[gi]}
    best = TrainResult(params, bn_state, float(best_loss[gi]),
                       float(best_acc[gi]), int(best_epoch[gi]),
                       mlp_cfg.epochs, cfg_history(gi))
    if out_dir:
        save_best_checkpoint(
            out_dir, "mlp_global_best", *convert.mlp_from_torch_state_dict(
                best.state_dict(), model_cfg), best_hp, best)

    results: Dict[str, Dict[str, float]] = {}
    store = GridResultStore(Path(out_dir) / "mlp_results.json") \
        if out_dir else None
    test_data = None if test_x is None else fast_loop.upload_eval_batches(
        ArrayDataset(np.asarray(test_x, np.float32),
                     np.asarray(test_y, np.int64)), batch_size, device)
    for i in range(n_cfg):
        key = GridResultStore.key(lr=lrs_py[i])
        summary = {"lr": lrs_py[i], "best_val_acc": float(best_acc[i]),
                   "best_val_loss": float(best_loss[i]),
                   "best_epoch": int(best_epoch[i])}
        if test_data is not None and i in snapshots:
            # the lr's best-epoch test accuracy (reference
            # Report.md:2686-2697), on the single-config model
            mlp = MLP(model_cfg, input_dim=input_dim)
            mlp.load_state_dict({**snapshots[i][0], **snapshots[i][1]})
            tm = _host(hbm.mlp_eval_sums(mlp.to(device), *test_data))
            summary["test_acc"] = float(tm["acc"] / tm["n"])
        results[key] = summary
        if store is not None:
            store.record(key, summary)

    if save_curves and out_dir:
        from satae_torch.eval import plots
        for i in range(n_cfg):
            plots.lr_curves(
                cfg_history(i),
                Path(out_dir) / "curves" / f"mlp_lr{lrs_py[i]:g}.png",
                title=f"MLP lr={lrs_py[i]:g}")
    return SweepResult(best, best_hp, results)
