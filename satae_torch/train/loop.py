"""Epoch-level trainers on the per-batch host loop: the counterpart of
satae/train/loop.py (``run_eval``, ``train_supervised_ae``, ``train_mlp``),
and the trainers' result contract (``TrainResult``, ``LogFn``).

This is satae's ``engine="steps"``: the batches come from ``iter_batches``
on the host, shuffled by ``default_rng(seed + epoch)`` and uploaded one by
one, and the epoch's remainder batch is kept (1,776 images at batch 64 are
27 full batches and one of 48); evaluation runs over unpadded batches.
Epoch metrics are sample-weighted means of the per-batch metrics, read
back once per epoch (satae's ``_reduce_batches``). Selection as satae's:
the AE stops after ``patience`` epochs without a lower val loss and keeps
its best epoch's weights; the MLP runs its epochs and keeps the best by val
accuracy. Parameters start from ``init_`` with
``torch.Generator().manual_seed(seed)`` (as satae_torch.train.fast_loop),
the augmentation and dropout draws come from a generator on the device
seeded ``seed``. On a CUDA device every linear layer runs on K1, as in the
scan engine. ``train_step``/``eval_step`` replace the steps (the tests
script them); data-parallel training (satae's ``mesh``) is a later slice
(ROADMAP.md §1 item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from satae_torch.config import DataConfig, ModelConfig
from satae_torch.data.pipeline import ArrayDataset, iter_batches
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn.init import init_
from satae_torch.train import steps as S
from satae_torch.train.optim import adam_init

LogFn = Callable[[str], None]


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]    # best-epoch parameters, by name
    bn_state: Dict[str, torch.Tensor]  # best-epoch BatchNorm buffers
    best_val_loss: float
    best_val_acc: float
    best_epoch: int
    epochs_run: int
    history: Dict[str, List[float]]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The best-epoch model as a state_dict (reference keys)."""
        return {**self.params, **self.bn_state}


def _weighted_mean(metric_sums: Dict[str, float], n: int) -> Dict[str, float]:
    return {k: v / n for k, v in metric_sums.items()}


def _reduce_batches(per_batch) -> Dict[str, float]:
    """One device -> host read for a whole epoch's (metrics, batch_size)
    pairs; the sums of metric * batch size in Python floats."""
    if not per_batch:
        return {}
    keys = list(per_batch[0][0])
    host = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m, _ in per_batch]).cpu().tolist()
    sums: Dict[str, float] = {}
    for values, (_, bs) in zip(host, per_batch):
        for k, v in zip(keys, values):
            sums[k] = sums.get(k, 0.0) + float(v) * bs
    return sums


def _up(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array on ``device``, in ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def run_eval(eval_step, ds: ArrayDataset, batch_size: int,
             device: torch.device) -> Dict[str, float]:
    """``eval_step(images, labels)`` over the unpadded batches of ``ds`` in
    order, each uploaded to ``device``: sample-weighted means of its
    metrics."""
    per_batch = []
    n = 0
    for imgs, labels in iter_batches(ds, batch_size, shuffle=False):
        metrics = eval_step(_up(imgs, device),
                            _up(labels, device, torch.long))
        per_batch.append((metrics, len(labels)))
        n += len(labels)
    return _weighted_mean(_reduce_batches(per_batch), n)


def _snapshot(model: torch.nn.Module):
    """(params, buffers) copies on the model's device."""
    return ({k: v.detach().clone() for k, v in model.named_parameters()},
            {k: v.detach().clone() for k, v in model.named_buffers()})


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh: data-parallel training is a later slice (ROADMAP.md §1 "
            "item 8)")


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
    compute_dtype: torch.dtype = torch.float32,
    log: Optional[LogFn] = None,
    train_step=None,
    eval_step=None,
    mesh=None,
) -> TrainResult:
    """Train one (alpha, lr) supervised-AE config with early stopping on the
    per-batch loop, computing in ``compute_dtype``. ``train_step(model,
    opt, imgs_u8, labels, alpha, lr)`` and ``eval_step(model, imgs_u8,
    labels, alpha)`` default to satae_torch.train.steps' AE steps."""
    _refuse_mesh(mesh)
    model = SupervisedAE(model_cfg, data_cfg.channels, data_cfg.image_size)
    init_(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(seed)
    train_step = train_step or (
        lambda m, o, x, y, a, r: S.ae_train_step(
            m, o, x, y, a, r, data_cfg, generator=gen,
            dtype=compute_dtype)[0])
    eval_step = eval_step or (
        lambda m, x, y, a: S.ae_eval_step(m, x, y, a, compute_dtype))

    history: Dict[str, List[float]] = {
        "train_loss": [], "val_loss": [], "train_mse": [], "val_mse": [],
        "train_ce": [], "val_ce": [], "train_acc": [], "val_acc": []}
    best_val = float("inf")
    best_val_acc = 0.0
    best_epoch = -1
    best = _snapshot(model)
    epochs_no_improve = 0
    epoch = 0

    for epoch in range(max_epochs):
        n_seen = 0
        per_batch = []
        for imgs, labels in iter_batches(train_ds, data_cfg.batch_size,
                                         shuffle=True, seed=seed,
                                         epoch=epoch):
            metrics = train_step(model, opt, _up(imgs, device),
                                 _up(labels, device, torch.long), alpha, lr)
            per_batch.append((metrics, len(labels)))
            n_seen += len(labels)
        train_m = _weighted_mean(_reduce_batches(per_batch), n_seen)
        val_m = run_eval(lambda x, y: eval_step(model, x, y, alpha), val_ds,
                         data_cfg.batch_size, device)
        for k in ("loss", "mse", "ce", "acc"):
            history[f"train_{k}"].append(train_m[k])
            history[f"val_{k}"].append(val_m[k])
        if log:
            log(f"epoch {epoch:3d}  train_loss={train_m['loss']:.4f} "
                f"val_loss={val_m['loss']:.4f} val_acc={val_m['acc']:.4f}")
        if val_m["loss"] < best_val:
            best_val = val_m["loss"]
            best_val_acc = val_m["acc"]
            best_epoch = epoch
            best = _snapshot(model)
            epochs_no_improve = 0
        else:
            epochs_no_improve += 1
            if epochs_no_improve >= patience:
                break

    return TrainResult(*best, best_val, best_val_acc, best_epoch, epoch + 1,
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
    train_step=None,
    eval_step=None,
) -> TrainResult:
    """Train the latent MLP on the per-batch loop; best epoch by val
    accuracy. ``train_step(model, opt, x, labels, lr, weight_decay)`` and
    ``eval_step(model, x, labels)`` default to satae_torch.train.steps' MLP
    steps."""
    model = MLP(model_cfg, input_dim=train_x.shape[-1])
    init_(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator(device=device).manual_seed(seed)
    train_step = train_step or (
        lambda m, o, x, y, r, wd: S.mlp_train_step(m, o, x, y, r, wd,
                                                   generator=gen)[0])
    eval_step = eval_step or S.mlp_eval_step

    train_ds = ArrayDataset(np.asarray(train_x, np.float32), train_y)
    val_ds = ArrayDataset(np.asarray(val_x, np.float32), val_y)
    history: Dict[str, List[float]] = {
        "train_loss": [], "val_loss": [], "train_acc": [], "val_acc": []}
    best_acc = -1.0
    best_loss = float("inf")
    best_epoch = -1
    best = _snapshot(model)

    for epoch in range(epochs):
        per_batch = []
        for xb, yb in iter_batches(train_ds, batch_size, shuffle=True,
                                   seed=seed, epoch=epoch):
            metrics = train_step(model, opt, _up(xb, device),
                                 _up(yb, device, torch.long), lr,
                                 weight_decay)
            per_batch.append((metrics, len(yb)))
        train_m = _weighted_mean(_reduce_batches(per_batch), len(train_ds))
        val_m = run_eval(lambda x, y: eval_step(model, x, y), val_ds,
                         batch_size, device)
        history["train_loss"].append(train_m["loss"])
        history["train_acc"].append(train_m["acc"])
        history["val_loss"].append(val_m["loss"])
        history["val_acc"].append(val_m["acc"])
        if log:
            log(f"epoch {epoch:3d}  train_acc={train_m['acc']:.4f} "
                f"val_acc={val_m['acc']:.4f}")
        if val_m["acc"] > best_acc:
            best_acc = val_m["acc"]
            best_loss = val_m["loss"]
            best_epoch = epoch
            best = _snapshot(model)

    return TrainResult(*best, best_loss, best_acc, best_epoch, epochs,
                       history)
