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
in float32. Data-parallel training is a later slice (ROADMAP.md §1
item 8).

``checkpoint_path`` with ``checkpoint_every=k`` is satae's in-flight resume
(fast_loop.py:80-96, :168-196, :262-275): every k epochs the AE's
parameters, BatchNorm stats, Adam's moments and step, the early-stopping
book and history go to ``checkpoint_path`` (satae's train-state pair) and
the best-epoch snapshot to ``.best.msgpack``; an existing pair at that path
is resumed from, at the flushed epoch + 1. The files are satae's, so either
package resumes the other's. The augmentation generator's state travels in
the ``.state.json`` under a key satae ignores (``torch_generator``), so a
resumed run repeats the uninterrupted one bit for bit; a pair written by
satae has none, and the augmentation after it is the port's own stream
(satae_torch.data.augment).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from satae_torch.config import DataConfig, ModelConfig
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.io import checkpoint, convert
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn.init import init_
from satae_torch.train import hbm
from satae_torch.train.loop import LogFn, TrainResult, _snapshot, _up
from satae_torch.train.optim import adam_init


def _host(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device -> host read of an epoch's sums."""
    keys = list(sums)
    return dict(zip(keys, torch.stack([sums[k] for k in keys]).tolist()))


def _check_full_batch(n: int, batch_size: int, what: str) -> None:
    if n < batch_size:
        raise ValueError(
            f"{what} ({n}) is smaller than batch_size ({batch_size}); the "
            "trainer trains on full batches only")


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
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
) -> TrainResult:
    """Train one (alpha, lr) supervised-AE config with early stopping,
    computing in ``compute_dtype``. ``device_data``: :func:`upload_ae_data`
    of the same splits. ``checkpoint_path``/``checkpoint_every``: the
    in-flight resume of the module docstring."""
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
    start_epoch = 0
    inflight = _Inflight(checkpoint_path, model, opt, gen, model_cfg,
                         data_cfg)
    if inflight.exists():
        meta, restored_best = inflight.restore()
        best = restored_best or best
        start_epoch = meta["epoch"] + 1
        best_val = meta.get("best_val", best_val)
        best_val_acc = meta.get("best_val_acc", best_val_acc)
        best_epoch = meta.get("best_epoch", best_epoch)
        bad = meta.get("bad", 0)
        for k in history:
            history[k] = list(meta.get("history", {}).get(k, []))
        if log:
            log(f"resumed from {checkpoint_path} at epoch {start_epoch}")
    # a resumed run that had already stopped trains nothing; epochs_run
    # stays the real count
    epochs_run = start_epoch
    if bad >= patience:
        start_epoch = max_epochs
    for epoch in range(start_epoch, max_epochs):
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
        if inflight.path is not None and checkpoint_every \
                and (epoch + 1) % checkpoint_every == 0:
            inflight.flush(epoch, best, dict(
                best_val=best_val, best_val_acc=best_val_acc,
                best_epoch=best_epoch, bad=bad, history=history))
        if bad >= patience:
            break
    return TrainResult(*best, best_val, best_val_acc, best_epoch, epochs_run,
                       history)


class _Inflight:
    """The in-flight files of one AE training at ``path`` (None: none):
    satae's train-state pair and best-epoch snapshot, carried to and from
    the model, its Adam state and its augmentation generator."""

    def __init__(self, path: Optional[str], model: SupervisedAE, opt,
                 gen: torch.Generator, model_cfg: ModelConfig,
                 data_cfg: DataConfig):
        self.path = None if path is None else Path(path)
        self.model, self.opt, self.gen = model, opt, gen
        self.names = [n for n, _ in model.named_parameters()]
        self.to_trees = lambda sd: convert.sae_from_torch_state_dict(
            sd, model_cfg, data_cfg.channels, data_cfg.image_size)
        self.from_trees = lambda p, s: convert.to_tensors(
            convert.sae_to_torch_state_dict(p, s, model_cfg,
                                            data_cfg.image_size))

    def exists(self) -> bool:
        return self.path is not None and self.path.exists()

    def best_file(self) -> Path:
        return self.path.with_suffix(".best.msgpack")

    def flush(self, epoch: int, best, extra: Dict) -> None:
        """The best snapshot first, then the state/meta pair (satae's order:
        a kill between them leaves the meta one flush old, and the resume
        finds the improvement again instead of mislabelling stale
        weights)."""
        checkpoint.save_model(self.best_file(),
                              *self.to_trees({**best[0], **best[1]}))
        sd = self.model.state_dict()
        params, bn_state = self.to_trees(sd)
        opt_state = convert.opt_state_to_tree(
            self.names, self.opt.mu, self.opt.nu, self.opt.step, sd,
            self.to_trees)
        state = self.gen.get_state().numpy().tobytes().hex()
        checkpoint.save_train_state(
            self.path, params=params, bn_state=bn_state, opt_state=opt_state,
            epoch=epoch, extra={**extra, "torch_generator": state})

    def restore(self):
        """Load the pair into the model, Adam and the generator. Returns
        (meta, the best snapshot as :func:`_snapshot` gives it, or None
        where there is no snapshot file)."""
        params, bn_state, opt_state, meta = checkpoint.load_train_state(
            self.path)
        self.model.load_state_dict(self.from_trees(params, bn_state))
        mu, nu, step = convert.opt_state_from_tree(
            opt_state, bn_state, self.names, self.from_trees)
        with torch.no_grad():
            for dst, src in zip(self.opt.mu + self.opt.nu, mu + nu):
                dst.copy_(src)
        self.opt.step = step
        if "torch_generator" in meta:
            self.gen.set_state(torch.frombuffer(
                bytearray.fromhex(meta.pop("torch_generator")),
                dtype=torch.uint8))
        best = None
        if self.best_file().exists():
            sd = self.from_trees(*checkpoint.load_model(self.best_file()))
            dev = next(self.model.parameters()).device
            best = tuple({k: sd[k].to(dev) for k, _ in named}
                         for named in (self.model.named_parameters(),
                                       self.model.named_buffers()))
        return meta, best


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
