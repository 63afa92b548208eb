"""Single-config trainers: the counterpart of satae/train/fast_loop.py's
``train_supervised_ae_scan`` and ``train_mlp_scan``.

Same selection semantics as satae:
  * AE: up to ``max_epochs``, validation after every epoch, early stop after
    ``patience`` epochs without a lower val loss, and a true best-epoch
    snapshot (a copy of the weights, not a reference to them);
  * MLP: a fixed number of epochs, best epoch by val accuracy.

satae pipelines its readback (epoch e + 1 is dispatched before epoch e's
metrics are read) and discards the epoch in flight on an early stop
(fast_loop.py:250-258). The port reads each epoch's sums back when the epoch
ends, which decides the same stop at the same epoch, so ``best_epoch``,
``epochs_run`` and the history come out as satae's.

Parameters start from PyTorch's default init drawn from a CPU generator
seeded with ``seed`` (the same weights on every device); the augmentation
and dropout draws come from a generator on the training device. The training
set must hold at least one full batch. A sweep uploads its data once
(:func:`upload_ae_data`, :func:`upload_mlp_data`) and passes it to every
config as ``device_data``, as satae's grid search does; without it each call
uploads its own. ``compute_dtype`` is satae's: the AE computes in it
(bf16 for the bf16 recipe) while its parameters, BatchNorm stats, Adam's
moments and the selection metrics stay float32, so a bf16 run's snapshots
and checkpoints are the float32 ones a float32 run writes. The MLP trains
in float32. Checkpointed resume and data-parallel training are later
slices (ROADMAP.md §1 items 9, 13).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from satae_torch.config import DataConfig, ModelConfig
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn.init import init_
from satae_torch.train import hbm
from satae_torch.train.loop import LogFn, TrainResult
from satae_torch.train.optim import adam_init


def _snapshot(model: torch.nn.Module):
    """(params, buffers) copies on the model's device."""
    return ({k: v.detach().clone() for k, v in model.named_parameters()},
            {k: v.detach().clone() for k, v in model.named_buffers()})


def _host(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device -> host read of an epoch's sums."""
    keys = list(sums)
    return dict(zip(keys, torch.stack([sums[k] for k in keys]).tolist()))


def _check_full_batch(n: int, batch_size: int, what: str) -> None:
    if n < batch_size:
        raise ValueError(
            f"{what} ({n}) is smaller than batch_size ({batch_size}); the "
            "trainer trains on full batches only")


def _up(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def upload_eval_batches(ds: ArrayDataset, batch_size: int,
                        device: torch.device) -> Tuple[torch.Tensor, ...]:
    """A split as zero-weight padded batches on ``device``: (inputs
    (nb, B, ...), int64 labels (nb, B), weights (nb, B))."""
    x, y, w = hbm.padded_eval_batches(ds, batch_size)
    return _up(x, device), _up(y, device, torch.long), _up(w, device)


def upload_ae_data(train_ds: ArrayDataset, val_ds: ArrayDataset,
                   batch_size: int, device: torch.device
                   ) -> Tuple[torch.Tensor, ...]:
    """The train split (uint8 images, int64 labels) and the padded val
    batches on ``device``, uploaded once."""
    return (_up(train_ds.images, device),
            _up(train_ds.labels, device, torch.long),
            *upload_eval_batches(val_ds, batch_size, device))


def upload_mlp_data(train_x: np.ndarray, train_y: np.ndarray,
                    val_x: np.ndarray, val_y: np.ndarray, batch_size: int,
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The training latents (float32) and labels (int64) and the padded val
    batches on ``device``, uploaded once."""
    val = ArrayDataset(np.asarray(val_x, np.float32),
                       np.asarray(val_y, np.int64))
    return (_up(np.asarray(train_x, np.float32), device),
            _up(train_y, device, torch.long),
            *upload_eval_batches(val, batch_size, device))


def train_supervised_ae(
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    *,
    model_cfg: ModelConfig,
    data_cfg: DataConfig,
    alpha: float,
    lr: float,
    device: torch.device,
    max_epochs: int = 80,
    patience: int = 15,
    seed: int = 0,
    log: Optional[LogFn] = None,
    device_data: Optional[Tuple[torch.Tensor, ...]] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> TrainResult:
    """Train one (alpha, lr) supervised-AE config with early stopping,
    computing in ``compute_dtype``. ``device_data``: :func:`upload_ae_data`
    of the same splits."""
    _check_full_batch(len(train_ds), data_cfg.batch_size, "train split")
    images, labels, val_imgs, val_labs, val_wts = device_data or \
        upload_ae_data(train_ds, val_ds, data_cfg.batch_size, device)
    model = SupervisedAE(model_cfg, data_cfg.channels, data_cfg.image_size)
    init_(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(seed)

    n_counted = (len(train_ds) // data_cfg.batch_size) * data_cfg.batch_size
    history: Dict[str, List[float]] = {
        "train_loss": [], "val_loss": [], "train_mse": [], "val_mse": [],
        "train_ce": [], "val_ce": [], "train_acc": [], "val_acc": []}
    best_val, best_val_acc, best_epoch = float("inf"), 0.0, -1
    best = _snapshot(model)
    bad = 0
    epochs_run = 0
    for epoch in range(max_epochs):
        order = hbm.epoch_order(len(train_ds), data_cfg.batch_size, seed,
                                epoch)
        tsum = _host(hbm.ae_train_epoch(model, opt, images, labels, order,
                                        alpha, lr, data_cfg, gen,
                                        compute_dtype))
        vsum = _host(hbm.ae_eval_sums(model, val_imgs, val_labs, val_wts,
                                      alpha, compute_dtype))
        for k in ("loss", "mse", "ce", "acc"):
            history[f"train_{k}"].append(tsum[k] / n_counted)
            history[f"val_{k}"].append(vsum[k] / vsum["n"])
        val_loss = history["val_loss"][-1]
        epochs_run = epoch + 1
        if log:
            log(f"epoch {epoch:3d}  train_loss={history['train_loss'][-1]:.4f} "
                f"val_loss={val_loss:.4f} val_acc={history['val_acc'][-1]:.4f}")
        if val_loss < best_val:
            best_val, best_val_acc = val_loss, history["val_acc"][-1]
            best_epoch = epoch
            best = _snapshot(model)
            bad = 0
        else:
            bad += 1
            if bad >= patience:
                break
    return TrainResult(*best, best_val, best_val_acc, best_epoch, epochs_run,
                       history)


def train_mlp(
    train_x: np.ndarray, train_y: np.ndarray,
    val_x: np.ndarray, val_y: np.ndarray,
    *,
    model_cfg: ModelConfig,
    lr: float,
    device: torch.device,
    weight_decay: float = 1e-4,
    epochs: int = 30,
    batch_size: int = 64,
    seed: int = 0,
    log: Optional[LogFn] = None,
    device_data: Optional[Tuple[torch.Tensor, ...]] = None,
) -> TrainResult:
    """Train the latent MLP for ``epochs``; best epoch by val accuracy.
    ``device_data``: :func:`upload_mlp_data` of the same arrays."""
    _check_full_batch(len(train_y), batch_size, "train set")
    xs, ys, vx, vy, vw = device_data or upload_mlp_data(
        train_x, train_y, val_x, val_y, batch_size, device)
    model = MLP(model_cfg, input_dim=train_x.shape[-1])
    init_(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(seed)

    n_counted = (len(train_y) // batch_size) * batch_size
    history: Dict[str, List[float]] = {
        "train_loss": [], "val_loss": [], "train_acc": [], "val_acc": []}
    best_acc, best_loss, best_epoch = -1.0, float("inf"), -1
    best = _snapshot(model)
    for epoch in range(epochs):
        order = hbm.epoch_order(len(train_y), batch_size, seed, epoch)
        tsum = _host(hbm.mlp_train_epoch(model, opt, xs, ys, order, lr,
                                         weight_decay, gen))
        vsum = _host(hbm.mlp_eval_sums(model, vx, vy, vw))
        history["train_loss"].append(tsum["loss"] / n_counted)
        history["train_acc"].append(tsum["acc"] / n_counted)
        history["val_loss"].append(vsum["loss"] / vsum["n"])
        history["val_acc"].append(vsum["acc"] / vsum["n"])
        if log:
            log(f"epoch {epoch:3d}  train_acc={history['train_acc'][-1]:.4f} "
                f"val_acc={history['val_acc'][-1]:.4f}")
        if history["val_acc"][-1] > best_acc:
            best_acc, best_loss = history["val_acc"][-1], history["val_loss"][-1]
            best_epoch = epoch
            best = _snapshot(model)
    return TrainResult(*best, best_loss, best_acc, best_epoch, epochs,
                       history)
