"""Hyperparameter grid searches (reference C16 and C22): the port's copy of
satae/train/gridsearch.py.

AE sweep: alpha x lr (5 x 9 = 45 configs by default), fresh init per config
seeded ``seed + cfg_idx`` in loop order, early stopping, global best by val
loss (``ae_global_best.msgpack``, the reference's AE_GLOBAL_BEST.pt). MLP
sweep: 11 lrs, fixed epochs, global best by val accuracy
(``mlp_global_best.msgpack``). Each config's summary is flushed to the
store (``validation_losses.json`` / ``mlp_results.json``) under satae's
keys, so a sweep resumes a run directory of either package; the selection
contract is satae_torch.train.sweep_common's.

``engine="scan"`` (the default) uploads the data once per sweep and trains
every config on it (satae_torch.train.fast_loop); any other engine is
satae's ``"steps"``, the per-batch host loop of satae_torch.train.loop,
which keeps each epoch's remainder batch. The AE sweep computes in
``compute_dtype``
(satae's; the stores, keys and checkpoints are the same in bf16, the master
parameters being float32); the MLP sweep is float32.

With ``AETrainConfig.checkpoint_every`` and ``out_dir`` each AE config of
the scan engine also flushes its in-flight train state every N epochs under
satae's names,
``out_dir/inflight/ae_a{alpha:g}_lr{lr:g}.msgpack``, so a kill mid-config
retrains at most N epochs of it; the files go once the config is recorded
(satae/train/gridsearch.py:86-106, :138). ``save_curves`` draws satae's
per-config figures under ``out_dir/curves/`` (matplotlib required). The
config-batched engine is satae_torch.train.vmap_sweep.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                ModelConfig)
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.io import convert
from satae_torch.io.checkpoint import GridResultStore, clear_train_state
from satae_torch.models.mlp import MLP
from satae_torch.train import fast_loop, hbm, loop
from satae_torch.train.loop import LogFn, TrainResult
from satae_torch.train.sweep_common import SweepBook


@dataclasses.dataclass
class SweepResult:
    best: TrainResult
    best_hparams: Dict[str, float]
    results: Dict[str, Dict[str, float]]  # key -> summary metrics


def ae_grid_search(
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    *,
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    ae_cfg: AETrainConfig,
    device: torch.device,
    seed: int = 0,
    out_dir: Optional[str] = None,
    log: Optional[LogFn] = None,
    engine: str = "scan",
    compute_dtype: torch.dtype = torch.float32,
    save_curves: bool = False,
) -> SweepResult:
    """Sequential alpha x lr sweep with per-config result flushing and a
    global-best checkpoint, each config computing in ``compute_dtype``."""
    scan = engine == "scan"
    device_data = fast_loop.upload_ae_data(
        train_ds, val_ds, data_cfg.batch_size, device) if scan else None
    book = SweepBook(
        out_dir, ckpt_name="ae_global_best",
        store_name="validation_losses.json", mode="min",
        hp_keys=("alpha", "lr"),
        to_trees=lambda res: convert.sae_from_torch_state_dict(
            res.state_dict(), model_cfg, data_cfg.channels,
            data_cfg.image_size),
        from_trees=lambda p, s: convert.to_tensors(
            convert.sae_to_torch_state_dict(p, s, model_cfg,
                                            data_cfg.image_size)))

    def inflight_path(alpha: float, lr: float) -> Optional[Path]:
        if out_dir and ae_cfg.checkpoint_every and scan:
            return (Path(out_dir) / "inflight" /
                    f"ae_a{alpha:g}_lr{lr:g}.msgpack")
        return None

    cfg_idx = -1
    for alpha in ae_cfg.alphas:
        for lr in ae_cfg.learning_rates:
            cfg_idx += 1
            key = GridResultStore.key(alpha=alpha, lr=lr)
            ckpt = inflight_path(alpha, lr)
            if book.cached(key):
                # also the files a kill between the store flush and their
                # removal left behind
                if ckpt is not None:
                    clear_train_state(ckpt)
                if log:
                    log(f"skip cached alpha={alpha} lr={lr}")
                continue
            if scan:
                res = fast_loop.train_supervised_ae(
                    train_ds, val_ds, model_cfg=model_cfg, data_cfg=data_cfg,
                    alpha=alpha, lr=lr, device=device,
                    max_epochs=ae_cfg.max_epochs, patience=ae_cfg.patience,
                    seed=seed + cfg_idx, device_data=device_data,
                    compute_dtype=compute_dtype,
                    checkpoint_path=None if ckpt is None else str(ckpt),
                    checkpoint_every=ae_cfg.checkpoint_every,
                    # per-epoch lines (and the resume point) only for the
                    # checkpointed configs, as satae logs them
                    log=log if ckpt is not None else None)
            else:
                res = loop.train_supervised_ae(
                    train_ds, val_ds, model_cfg=model_cfg, data_cfg=data_cfg,
                    alpha=alpha, lr=lr, device=device,
                    max_epochs=ae_cfg.max_epochs, patience=ae_cfg.patience,
                    seed=seed + cfg_idx, compute_dtype=compute_dtype)
            # offer (checkpoint save) strictly before the store flush: a
            # crash between the two costs a retrain on resume, never a
            # cached-but-uncheckpointed winner left out of selection
            book.offer(res, {"alpha": alpha, "lr": lr})
            book.record(key, {"alpha": alpha, "lr": lr,
                              "best_val_loss": res.best_val_loss,
                              "best_val_acc": res.best_val_acc,
                              "best_epoch": res.best_epoch,
                              "epochs_run": res.epochs_run})
            if ckpt is not None:
                clear_train_state(ckpt)  # the config is recorded
            if save_curves and out_dir and res.history:
                from satae_torch.eval import plots
                plots.loss_curves(
                    res.history,
                    Path(out_dir) / "curves" / f"ae_alpha{alpha:g}_lr{lr:g}.png",
                    title=f"AE alpha={alpha:g} lr={lr:g}")
            if log:
                log(f"alpha={alpha} lr={lr}: val_loss={res.best_val_loss:.4f} "
                    f"({res.epochs_run} epochs)")

    best, best_hp = book.resolve("AE grid search")
    return SweepResult(best, best_hp, book.results)


def mlp_grid_search(
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
    engine: str = "scan",
    test_x: Optional[np.ndarray] = None,
    test_y: Optional[np.ndarray] = None,
    save_curves: bool = False,
) -> SweepResult:
    """The lr sweep over the latent MLP; global best by val accuracy. With
    test_x/test_y each lr's summary also records its best epoch's test
    accuracy, as the reference's per-lr test evaluation does."""
    scan = engine == "scan"
    input_dim = train_x.shape[-1]
    device_data = fast_loop.upload_mlp_data(
        train_x, train_y, val_x, val_y, batch_size, device) if scan else None
    test_data = None if test_x is None else fast_loop.upload_eval_batches(
        ArrayDataset(np.asarray(test_x, np.float32),
                     np.asarray(test_y, np.int64)), batch_size, device)
    book = SweepBook(
        out_dir, ckpt_name="mlp_global_best", store_name="mlp_results.json",
        mode="max", hp_keys=("lr",),
        to_trees=lambda res: convert.mlp_from_torch_state_dict(
            res.state_dict(), model_cfg),
        from_trees=lambda p, s: convert.to_tensors(
            convert.mlp_to_torch_state_dict(p, s, model_cfg)))

    for cfg_idx, lr in enumerate(mlp_cfg.learning_rates):
        key = GridResultStore.key(lr=lr)
        if book.cached(key):
            if log:
                log(f"skip cached lr={lr}")
            continue
        kw = dict(model_cfg=model_cfg, lr=lr, device=device,
                  weight_decay=mlp_cfg.weight_decay, epochs=mlp_cfg.epochs,
                  batch_size=batch_size, seed=seed + cfg_idx)
        if scan:
            res = fast_loop.train_mlp(train_x, train_y, val_x, val_y,
                                      device_data=device_data, **kw)
        else:
            res = loop.train_mlp(train_x, train_y, val_x, val_y, **kw)
        summary = {"lr": lr, "best_val_acc": res.best_val_acc,
                   "best_val_loss": res.best_val_loss,
                   "best_epoch": res.best_epoch}
        if test_data is not None:
            mlp = MLP(model_cfg, input_dim=input_dim).to(device)
            mlp.load_state_dict(res.state_dict())
            sums = hbm.mlp_eval_sums(mlp, *test_data)
            summary["test_acc"] = float(sums["acc"]) / float(sums["n"])
        book.offer(res, {"lr": lr})  # checkpoint before the store flush
        book.record(key, summary)
        if save_curves and out_dir and res.history:
            from satae_torch.eval import plots
            plots.lr_curves(res.history,
                            Path(out_dir) / "curves" / f"mlp_lr{lr:g}.png",
                            title=f"MLP lr={lr:g}")
        if log:
            log(f"lr={lr}: val_acc={res.best_val_acc:.4f}")

    best, best_hp = book.resolve("MLP grid search")
    return SweepResult(best, best_hp, book.results)
