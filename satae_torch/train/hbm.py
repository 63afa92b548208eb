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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from satae_torch.config import DataConfig
from satae_torch.data.augment import normalize
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.train.optim import AdamState
from satae_torch.train.steps import ae_train_step, mlp_train_step

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


def ae_train_epoch(model: SupervisedAE, opt: AdamState, images: torch.Tensor,
                   labels: torch.Tensor, order: np.ndarray, alpha: float,
                   lr: float, data_cfg: DataConfig,
                   generator: Optional[torch.Generator],
                   dtype: torch.dtype = torch.float32) -> Sums:
    """One AE epoch over the device-resident uint8 ``images`` in ``order``,
    computing in ``dtype``; returns per-sample weighted float32 metric sums
    (divide by ``order.size``)."""
    msum = _zeros(("loss", "mse", "ce", "acc"), images.device)
    for idx in torch.from_numpy(order).to(images.device):
        metrics, _ = ae_train_step(
            model, opt, images.index_select(0, idx),
            labels.index_select(0, idx), alpha, lr, data_cfg,
            generator=generator, dtype=dtype)
        for k in msum:
            msum[k] += metrics[k] * idx.numel()
    return msum


@torch.no_grad()
def ae_eval_sums(model: SupervisedAE, images: torch.Tensor,
                 labels: torch.Tensor, weights: torch.Tensor,
                 alpha: float, dtype: torch.dtype = torch.float32) -> Sums:
    """Weighted float32 metric sums over padded eval batches (nb, B, ...),
    the model run in ``dtype``, as satae's ``ae_eval_body``: divide by the
    returned ``n``."""
    model.eval()
    msum = _zeros(("loss", "mse", "ce", "acc", "n"), images.device)
    for imgs_u8, labs, wts in zip(images, labels, weights):
        imgs = normalize(imgs_u8, dtype)
        x_hat, logits, _ = model(imgs)
        se = torch.sum(torch.square((x_hat - imgs).float())
                       * wts[:, None, None, None]) / x_hat[0].numel()
        logits32 = logits.float()
        logz = torch.logsumexp(logits32, dim=-1)
        tl = logits32.gather(-1, labs[:, None])[:, 0]
        ce = torch.sum((logz - tl) * wts)
        correct = torch.sum((torch.argmax(logits, -1) == labs) * wts)
        msum["loss"] += alpha * se + ce
        msum["mse"] += se
        msum["ce"] += ce
        msum["acc"] += correct
        msum["n"] += torch.sum(wts)
    return msum


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
