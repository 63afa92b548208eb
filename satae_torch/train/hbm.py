"""Device-resident dataset and epoch bodies: the counterpart of
satae/train/hbm.py.

The uint8 split is uploaded to the device once; each train step gathers its
batch there by index (``epoch_order``'s row), and the epoch's metric sums
stay on the device until the trainer reads them once per epoch. satae runs
each epoch as one ``lax.scan`` program; here it is a Python loop of eager
steps, which is what PyTorch offers without graph capture.

Epoch accounting is satae's:
  * train: full batches only (the shuffled remainder is dropped each epoch);
    metric sums are per-sample weighted;
  * eval: the split is zero-padded to whole batches with zero-weight rows,
    so the weighted sums equal unpadded evaluation.

The AE bodies take satae's ``compute_dtype`` as ``dtype``; their sums
accumulate in float32 whatever it is (the differences and logits taken in
``dtype`` first, hbm.py:216-222), so the selection metrics do not depend on
it. The MLP bodies are float32.

The ``stacked_*`` bodies are the same epochs for every config of a
satae_torch.models.stacked model at once, satae's bodies under
``jax.vmap`` (satae/train/vmap_sweep.py:72-76, :228-232): one shared
batch order, per-config draws, and sums of shape (C,) (``n`` stays a
scalar).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from satae_torch.config import DataConfig
from satae_torch.data.augment import normalize
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.models.mlp import MLP
from satae_torch.models.stacked import StackedMLP, StackedSupervisedAE
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn.stacked import fold
from satae_torch.train.optim import AdamState
from satae_torch.train.steps import (ae_train_step, mlp_train_step,
                                     stacked_ae_train_step,
                                     stacked_mlp_train_step)

Sums = Dict[str, torch.Tensor]


def epoch_order(n: int, batch_size: int, seed: int, epoch: int) -> np.ndarray:
    """Shuffled full-batch index matrix (n_steps, batch_size) for one epoch:
    satae's stream, ``default_rng(seed + epoch).permutation(n)`` (its
    docstring, hbm.py:36-50, says why the streams overlap across configs)."""
    perm = np.random.default_rng(seed + epoch).permutation(n)
    n_steps = n // batch_size
    return perm[: n_steps * batch_size].reshape(n_steps, batch_size)


def padded_eval_batches(ds: ArrayDataset, batch_size: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(images (nb,B,H,W,C), labels (nb,B), weights (nb,B)) with zero-weight
    padding rows so every batch is full."""
    n = len(ds)
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    images = np.concatenate(
        [ds.images, np.zeros((pad,) + ds.images.shape[1:], ds.images.dtype)])
    labels = np.concatenate([ds.labels, np.zeros((pad,), ds.labels.dtype)])
    weights = np.concatenate([np.ones((n,), np.float32),
                              np.zeros((pad,), np.float32)])
    shape = (nb, batch_size)
    return (images.reshape(shape + ds.images.shape[1:]),
            labels.reshape(shape), weights.reshape(shape))


def _zeros(keys, device) -> Sums:
    return {k: torch.zeros((), device=device) for k in keys}


def all_reduced(sums: Sums, mesh) -> Sums:
    """``sums`` summed over ``mesh``'s data axis, in one collective."""
    keys = list(sums)
    total = mesh.all_reduce_(torch.stack([sums[k] for k in keys]))
    return dict(zip(keys, total))


def ae_train_epoch(model: SupervisedAE, opt: AdamState, images: torch.Tensor,
                   labels: torch.Tensor, order: np.ndarray, alpha: float,
                   lr: float, data_cfg: DataConfig,
                   generator: Optional[torch.Generator],
                   dtype: torch.dtype = torch.float32, mesh=None) -> Sums:
    """One AE epoch over the device-resident uint8 ``images`` in ``order``,
    computing in ``dtype``; returns per-sample weighted float32 metric sums
    (divide by ``order.size``). With ``mesh`` each step trains this rank's
    rows of the order's batch, data-parallel (satae_torch.train.steps)."""
    msum = _zeros(("loss", "mse", "ce", "acc"), images.device)
    for idx in torch.from_numpy(order).to(images.device):
        mine = idx if mesh is None else mesh.shard(idx)
        metrics, _ = ae_train_step(
            model, opt, images.index_select(0, mine),
            labels.index_select(0, mine), alpha, lr, data_cfg,
            generator=generator, dtype=dtype, mesh=mesh)
        for k in msum:
            msum[k] += metrics[k] * idx.numel()
    return msum


def ae_eval_batch_sums(model: SupervisedAE, imgs_u8: torch.Tensor,
                       labs: torch.Tensor, wts: torch.Tensor, alpha: float,
                       dtype: torch.dtype = torch.float32) -> Sums:
    """One batch's weighted float32 sums of loss, mse, ce, acc and n, the
    model (in eval mode) run in ``dtype``: satae's ``ae_eval_body`` step and
    its data-parallel eval (dp.py:50-77)."""
    imgs = normalize(imgs_u8, dtype)
    x_hat, logits, _ = model(imgs)
    se = torch.sum(torch.square((x_hat - imgs).float())
                   * wts[:, None, None, None]) / x_hat[0].numel()
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    tl = logits32.gather(-1, labs[:, None])[:, 0]
    ce = torch.sum((logz - tl) * wts)
    return {"loss": alpha * se + ce, "mse": se, "ce": ce,
            "acc": torch.sum((torch.argmax(logits, -1) == labs) * wts),
            "n": torch.sum(wts)}


@torch.no_grad()
def ae_eval_sums(model: SupervisedAE, images: torch.Tensor,
                 labels: torch.Tensor, weights: torch.Tensor,
                 alpha: float, dtype: torch.dtype = torch.float32,
                 mesh=None) -> Sums:
    """Weighted float32 metric sums over padded eval batches (nb, B, ...),
    the model run in ``dtype``, as satae's ``ae_eval_body``: divide by the
    returned ``n``. With ``mesh`` each rank evaluates its rows of every
    batch and the sums are summed over the data axis."""
    model.eval()
    msum = _zeros(("loss", "mse", "ce", "acc", "n"), images.device)
    for batch in zip(images, labels, weights):
        if mesh is not None:
            batch = [mesh.shard(t) for t in batch]
        for k, v in ae_eval_batch_sums(model, *batch, alpha, dtype).items():
            msum[k] += v
    return msum if mesh is None else all_reduced(msum, mesh)


def mlp_train_epoch(model: MLP, opt: AdamState, xs: torch.Tensor,
                    ys: torch.Tensor, order: np.ndarray, lr: float,
                    weight_decay: float,
                    generator: Optional[torch.Generator]) -> Sums:
    """One MLP epoch over device-resident latents; sums of per-sample loss
    and of correct predictions."""
    msum = _zeros(("loss", "acc"), xs.device)
    for idx in torch.from_numpy(order).to(xs.device):
        yb = ys.index_select(0, idx)
        metrics, _ = mlp_train_step(model, opt, xs.index_select(0, idx), yb,
                                    lr, weight_decay, generator=generator)
        msum["loss"] += metrics["loss"] * idx.numel()
        msum["acc"] += metrics["acc"] * idx.numel()
    return msum


@torch.no_grad()
def mlp_eval_sums(model: MLP, xs: torch.Tensor, ys: torch.Tensor,
                  wts: torch.Tensor) -> Sums:
    """Weighted {loss, acc, n} over padded batches (nb, B, D), as satae's
    ``mlp_eval_body``."""
    model.eval()
    msum = _zeros(("loss", "acc", "n"), xs.device)
    for xb, yb, wb in zip(xs, ys, wts):
        logits = model(xb)
        logits32 = logits.float()
        logz = torch.logsumexp(logits32, dim=-1)
        tl = logits32.gather(-1, yb[:, None])[:, 0]
        msum["loss"] += torch.sum((logz - tl) * wb)
        msum["acc"] += torch.sum((torch.argmax(logits, -1) == yb) * wb)
        msum["n"] += torch.sum(wb)
    return msum


# ---- config-batched epochs (the vmap sweep engine) --------------------------

def _zeros_c(keys, c: int, device) -> Sums:
    return {k: torch.zeros(c, device=device) for k in keys}


def stacked_ae_train_epoch(model: StackedSupervisedAE, opt: AdamState,
                           images: torch.Tensor, labels: torch.Tensor,
                           order: np.ndarray, alphas: torch.Tensor,
                           lrs: torch.Tensor, data_cfg: DataConfig,
                           generator: Optional[torch.Generator],
                           dtype: torch.dtype = torch.float32) -> Sums:
    """:func:`ae_train_epoch` of every config at once on the shared
    ``order``: (C,) per-sample weighted float32 sums."""
    msum = _zeros_c(("loss", "mse", "ce", "acc"), model.n_configs,
                    images.device)
    for idx in torch.from_numpy(order).to(images.device):
        metrics, _ = stacked_ae_train_step(
            model, opt, images.index_select(0, idx),
            labels.index_select(0, idx), alphas, lrs, data_cfg,
            generator=generator, dtype=dtype)
        for k in msum:
            msum[k] += metrics[k] * idx.numel()
    return msum


@torch.no_grad()
def stacked_ae_eval_sums(model: StackedSupervisedAE, images: torch.Tensor,
                         labels: torch.Tensor, weights: torch.Tensor,
                         alphas: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> Sums:
    """:func:`ae_eval_sums` of every config: (C,) weighted sums of loss,
    mse, ce and acc, and the scalar weight ``n``."""
    model.eval()
    c = model.n_configs
    msum = _zeros_c(("loss", "mse", "ce", "acc"), c, images.device)
    msum["n"] = torch.zeros((), device=images.device)
    for imgs_u8, labs, wts in zip(images, labels, weights):
        imgs = fold(normalize(imgs_u8, dtype).expand(c, -1, -1, -1, -1))
        x_hat, logits, _ = model(imgs)
        d = torch.square((x_hat - imgs).float())
        b = d.shape[0]
        se = torch.sum(d.reshape(b, c, -1) * wts[:, None, None],
                       dim=(0, 2)) / (d[0].numel() // c)
        logits32 = logits.float()
        logz = torch.logsumexp(logits32, dim=-1)
        tl = logits32.gather(-1, labs[None, :, None].expand(c, -1, 1))[..., 0]
        ce = torch.sum((logz - tl) * wts, dim=1)
        correct = torch.sum((torch.argmax(logits, -1) == labs) * wts, dim=1)
        msum["loss"] += alphas * se + ce
        msum["mse"] += se
        msum["ce"] += ce
        msum["acc"] += correct
        msum["n"] += torch.sum(wts)
    return msum


def stacked_mlp_train_epoch(model: StackedMLP, opt: AdamState,
                            xs: torch.Tensor, ys: torch.Tensor,
                            order: np.ndarray, lrs: torch.Tensor,
                            weight_decay: float,
                            generator: Optional[torch.Generator]) -> Sums:
    """:func:`mlp_train_epoch` of every config at once: (C,) sums."""
    msum = _zeros_c(("loss", "acc"), model.n_configs, xs.device)
    for idx in torch.from_numpy(order).to(xs.device):
        metrics, _ = stacked_mlp_train_step(
            model, opt, xs.index_select(0, idx), ys.index_select(0, idx),
            lrs, weight_decay, generator=generator)
        msum["loss"] += metrics["loss"] * idx.numel()
        msum["acc"] += metrics["acc"] * idx.numel()
    return msum


@torch.no_grad()
def stacked_mlp_eval_sums(model: StackedMLP, xs: torch.Tensor,
                          ys: torch.Tensor, wts: torch.Tensor) -> Sums:
    """:func:`mlp_eval_sums` of every config: (C,) loss and acc, scalar n."""
    model.eval()
    c = model.n_configs
    msum = _zeros_c(("loss", "acc"), c, xs.device)
    msum["n"] = torch.zeros((), device=xs.device)
    for xb, yb, wb in zip(xs, ys, wts):
        logits = model(xb.unsqueeze(0).expand(c, -1, -1))
        logits32 = logits.float()
        logz = torch.logsumexp(logits32, dim=-1)
        tl = logits32.gather(-1, yb[None, :, None].expand(c, -1, 1))[..., 0]
        msum["loss"] += torch.sum((logz - tl) * wb, dim=1)
        msum["acc"] += torch.sum((torch.argmax(logits, -1) == yb) * wb, dim=1)
        msum["n"] += torch.sum(wb)
    return msum
