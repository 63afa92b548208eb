"""Config-sharded hyperparameter sweeps: the counterpart of
satae/train/shard_sweep.py, one grid config per mesh row per round.

Each round trains as many configs as the mesh has rows (the config axis of
a 2-D mesh, every rank of a 1-D one), the last round padded by repeating
its final config (satae's ``_chunk_pad``; the padding slot trains nothing
here). Config ``i`` of the grid trains exactly as the sequential engine
trains it (satae_torch.train.gridsearch: ``seed + i``, the same trainer,
the data uploaded once per rank), so a 1-D sweep gives every config's
sequential result bit for bit on the same device and algorithms. On a 2-D
(config x data) mesh each AE config trains data-parallel over its row
(satae_torch.train.fast_loop with the row as ``mesh``); the MLP ignores the
data axis and every rank of a row trains its config, as satae's does
(shard_sweep.py:409-411).

After each round every rank gathers each config's summary and curves
(``all_gather_object``), so every rank keeps the same books: the same
store writes and checkpoints (atomic, identical bytes), the same log
lines. A config's best-epoch weights travel only where the selection needs
them, as the new global best or the all-diverged fallback: broadcast from
the config's first rank. The per-config figures are drawn by the primary
rank only. The selection contract is satae_torch.train.sweep_common's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                ModelConfig)
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.io import convert
from satae_torch.io.checkpoint import GridResultStore
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.parallel.distributed import is_primary
from satae_torch.parallel.mesh import Mesh
from satae_torch.train import fast_loop, hbm
from satae_torch.train.gridsearch import SweepResult
from satae_torch.train.loop import LogFn, TrainResult, _snapshot
from satae_torch.train.sweep_common import SweepBook


def _chunk_pad(items: List, n: int) -> List[Tuple[List, np.ndarray]]:
    """Rounds of exactly n, the last padded by repeating its final item;
    [(round_items, real_mask)]."""
    rounds = []
    for lo in range(0, len(items), n):
        chunk = list(items[lo:lo + n])
        mask = np.zeros((n,), bool)
        mask[:len(chunk)] = True
        while len(chunk) < n:
            chunk.append(chunk[-1])
        rounds.append((chunk, mask))
    return rounds


class _Rows:
    """The config axis of ``mesh``: its rows, this rank's row, each row's
    first (global) rank, and the mesh a row trains an AE config on."""

    def __init__(self, mesh: Mesh):
        two_d = len(mesh.axis_names) > 1
        self.n = mesh.shape[mesh.axis_names[0]]
        self.mine = mesh.row if two_d else mesh.rank
        self.width = mesh.data_size if two_d else 1
        self.first = mesh.data_rank == 0 if two_d else True
        self.dp = mesh if two_d else None

    def owner(self, slot: int) -> int:
        return slot * self.width


def _gather(payload: Any) -> List[Any]:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, payload)
    return out


def _fetch(res: Optional[TrainResult], template: torch.nn.Module,
           src: int) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The best-epoch (params, buffers) of the config trained on rank
    ``src``, on every rank (``res`` is that rank's result)."""
    params, bufs = _snapshot(template) if res is None else \
        (res.params, res.bn_state)
    state = {**params, **bufs}
    with torch.no_grad():
        for k in sorted(state):  # one order on every rank
            # a receiver's tensors are its own contiguous snapshot
            dist.broadcast(state[k].contiguous(), src=src)
    return params, bufs


def _wants(book: SweepBook, loss: float, acc: float) -> bool:
    """Whether ``book.offer`` would keep a config with these metrics (as
    the global best or the all-diverged fallback)."""
    metric = loss if book.mode == "min" else acc
    fb = float(np.nan_to_num(loss if book.mode == "min" else -acc,
                             nan=np.inf))
    return book.better(metric, book.best_metric()) or \
        book.fallback is None or fb < book.fallback_key


def ae_sharded_grid_search(
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    *,
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    ae_cfg: AETrainConfig,
    mesh: Mesh,
    device: torch.device,
    seed: int = 0,
    out_dir: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    log: Optional[LogFn] = None,
    save_curves: bool = False,
) -> SweepResult:
    """Config-sharded alpha x lr sweep over a 1-D or 2-D mesh (satae's
    shard_sweep.py:159): one config per row per round; on a 2-D mesh each
    config trains data-parallel over its row. Same store, resume and
    global-best checkpoint as satae_torch.train.gridsearch.ae_grid_search."""
    if len(train_ds) < data_cfg.batch_size:
        raise ValueError(
            f"train split ({len(train_ds)}) is smaller than batch_size "
            f"({data_cfg.batch_size}); the sharded sweep trains on full "
            "batches only - reduce batch_size")
    rows = _Rows(mesh)
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
    pending = []  # (cfg_idx, alpha, lr)
    ci = -1
    for alpha in ae_cfg.alphas:
        for lr in ae_cfg.learning_rates:
            ci += 1
            if book.cached(GridResultStore.key(alpha=alpha, lr=lr)):
                if log:
                    log(f"skip cached alpha={alpha} lr={lr}")
            else:
                pending.append((ci, alpha, lr))
    device_data = fast_loop.upload_ae_data(
        train_ds, val_ds, data_cfg.batch_size, device) if pending else None
    template = SupervisedAE(model_cfg, data_cfg.channels,
                            data_cfg.image_size).to(device)

    for chunk, mask in _chunk_pad(pending, rows.n):
        res = None
        if mask[rows.mine]:
            ci, alpha, lr = chunk[rows.mine]
            res = fast_loop.train_supervised_ae(
                train_ds, val_ds, model_cfg=model_cfg, data_cfg=data_cfg,
                alpha=alpha, lr=lr, device=device,
                max_epochs=ae_cfg.max_epochs, patience=ae_cfg.patience,
                seed=seed + ci, device_data=device_data,
                compute_dtype=compute_dtype, mesh=rows.dp)
        mine = None if res is None or not rows.first else (
            res.best_val_loss, res.best_val_acc, res.best_epoch,
            res.epochs_run, res.history)
        gathered = _gather(mine)
        for slot in np.flatnonzero(mask):
            _, alpha, lr = chunk[slot]
            src = rows.owner(slot)
            loss, acc, best_epoch, epochs_run, history = gathered[src]
            hp = {"alpha": alpha, "lr": lr}
            # checkpoint (offer) strictly before the store flush
            if _wants(book, loss, acc):
                snap = _fetch(res if rows.mine == slot else None, template,
                              src)
                book.offer(TrainResult(*snap, loss, acc, best_epoch,
                                       epochs_run, history), hp)
            book.record(GridResultStore.key(alpha=alpha, lr=lr), {
                "alpha": alpha, "lr": lr, "best_val_loss": loss,
                "best_val_acc": acc, "best_epoch": best_epoch,
                "epochs_run": epochs_run})
            if save_curves and out_dir and history and is_primary():
                from satae_torch.eval import plots
                plots.loss_curves(
                    history,
                    Path(out_dir) / "curves" / f"ae_alpha{alpha:g}_lr{lr:g}.png",
                    title=f"AE alpha={alpha:g} lr={lr:g}")
            if log:
                log(f"alpha={alpha} lr={lr}: val_loss={loss:.4f} "
                    f"({epochs_run} epochs)")

    best, best_hp = book.resolve("sharded AE grid search")
    return SweepResult(best, best_hp, book.results)


def mlp_sharded_grid_search(
    train_x: np.ndarray, train_y: np.ndarray,
    val_x: np.ndarray, val_y: np.ndarray,
    *,
    model_cfg: ModelConfig,
    mlp_cfg: MLPTrainConfig,
    mesh: Mesh,
    device: torch.device,
    batch_size: int = 64,
    seed: int = 0,
    out_dir: Optional[str] = None,
    log: Optional[LogFn] = None,
    test_x: Optional[np.ndarray] = None,
    test_y: Optional[np.ndarray] = None,
    save_curves: bool = False,
) -> SweepResult:
    """Config-sharded lr sweep of the latent MLP (satae's
    shard_sweep.py:394): fixed epochs, best by val accuracy, each lr's
    best-epoch test accuracy; on a 2-D mesh only the config axis is used.
    Same store, resume and checkpoint as
    satae_torch.train.gridsearch.mlp_grid_search."""
    if len(train_y) < batch_size:
        raise ValueError(
            f"train set ({len(train_y)}) is smaller than batch_size "
            f"({batch_size}); the sharded sweep trains on full batches only")
    rows = _Rows(mesh)
    input_dim = train_x.shape[-1]
    book = SweepBook(
        out_dir, ckpt_name="mlp_global_best", store_name="mlp_results.json",
        mode="max", hp_keys=("lr",),
        to_trees=lambda res: convert.mlp_from_torch_state_dict(
            res.state_dict(), model_cfg),
        from_trees=lambda p, s: convert.to_tensors(
            convert.mlp_to_torch_state_dict(p, s, model_cfg)))
    pending = []  # (cfg_idx, lr)
    for ci, lr in enumerate(mlp_cfg.learning_rates):
        if book.cached(GridResultStore.key(lr=lr)):
            if log:
                log(f"skip cached lr={lr}")
        else:
            pending.append((ci, lr))
    device_data = fast_loop.upload_mlp_data(
        train_x, train_y, val_x, val_y, batch_size, device) \
        if pending else None
    test_data = None if test_x is None or not pending else \
        fast_loop.upload_eval_batches(
            ArrayDataset(np.asarray(test_x, np.float32),
                         np.asarray(test_y, np.int64)), batch_size, device)
    template = MLP(model_cfg, input_dim=input_dim).to(device)

    for chunk, mask in _chunk_pad(pending, rows.n):
        res, mine = None, None
        if mask[rows.mine]:
            ci, lr = chunk[rows.mine]
            res = fast_loop.train_mlp(
                train_x, train_y, val_x, val_y, model_cfg=model_cfg, lr=lr,
                device=device, weight_decay=mlp_cfg.weight_decay,
                epochs=mlp_cfg.epochs, batch_size=batch_size, seed=seed + ci,
                device_data=device_data)
            test_acc = None
            if test_data is not None:
                template.load_state_dict(res.state_dict())
                sums = hbm.mlp_eval_sums(template, *test_data)
                test_acc = float(sums["acc"]) / float(sums["n"])
            if rows.first:
                mine = (res.best_val_loss, res.best_val_acc, res.best_epoch,
                        res.epochs_run, res.history, test_acc)
        gathered = _gather(mine)
        for slot in np.flatnonzero(mask):
            _, lr = chunk[slot]
            src = rows.owner(slot)
            loss, acc, best_epoch, epochs_run, history, test_acc = \
                gathered[src]
            summary = {"lr": lr, "best_val_acc": acc, "best_val_loss": loss,
                       "best_epoch": best_epoch}
            if test_acc is not None:
                summary["test_acc"] = test_acc
            if _wants(book, loss, acc):  # checkpoint before the store flush
                snap = _fetch(res if rows.mine == slot else None, template,
                              src)
                book.offer(TrainResult(*snap, loss, acc, best_epoch,
                                       epochs_run, history), {"lr": lr})
            book.record(GridResultStore.key(lr=lr), summary)
            if save_curves and out_dir and history and is_primary():
                from satae_torch.eval import plots
                plots.lr_curves(history,
                                Path(out_dir) / "curves" / f"mlp_lr{lr:g}.png",
                                title=f"MLP lr={lr:g}")
            if log:
                log(f"lr={lr}: val_acc={acc:.4f}")

    best, best_hp = book.resolve("sharded MLP grid search")
    return SweepResult(best, best_hp, book.results)
