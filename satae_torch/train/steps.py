"""Train and eval steps: the counterpart of satae/train/steps.py.

An AE train step is uint8 batch -> augmentation -> supervised-AE forward
(train mode: batch statistics, running stats updated in the modules'
buffers) -> alpha * MSE + CE -> gradients -> Adam, in place. On a CUDA
device every linear layer of the forward and of the backward runs on kernel
K1; the convolutions, BatchNorm, losses and Adam are PyTorch ops, as they
are XLA ops in satae. ``alpha``, ``lr`` and ``weight_decay`` are plain
arguments, so every config shares one step.

The random inputs of a step (the augmentation's flips, offsets and noise,
the MLP's dropout mask) are drawn from ``generator`` unless passed in, which
is how the tests replay satae's draws. ``linear`` selects the linear
function for a reference run (``layers.linear_plain``); the training path
never passes it.

The train steps return ``(metrics, grads)``: metric tensors stay on the
device until the caller reads them, and ``grads`` are the gradients the
update used, in ``model.parameters()`` order. Under
satae_torch.utils.profiling's ``debug_mode`` (``RuntimeConfig.debug_nans``)
a step checks its loss before the backward and its gradients after it, and
raises ``FloatingPointError`` at the first non-finite one.

``dtype`` is the AE steps' compute dtype, satae's ``compute_dtype``: the
batch is normalised and augmented in it and the model runs in it, while
the parameters, BatchNorm running stats, Adam's moments and the metrics stay
float32 (the losses accumulate in float32). The MLP steps are float32, as
satae's are.

The ``stacked_*`` steps are satae's steps under ``jax.vmap`` over a config
axis (satae/train/vmap_sweep.py): one step of every config of a
satae_torch.models.stacked model on the same batch, each config with its
own alpha and lr (``alphas``, ``lrs``: (C,) float32 tensors on the model's
device), its own augmentation draws (flips (C, B, 1), offsets (C, B, 2),
noise (C, B, H, W, ch)) or dropout mask (C, B, hidden), and its own
BatchNorm statistics. The per-config losses are reduced over the batch
only; the step differentiates their sum over configs, whose parameters are
disjoint, so each config's gradient is its own loss's. Metrics are (C,)
tensors. On a CUDA device a stacked AE step launches the batched K1 4 times
forward and 8 backward, a stacked MLP step 3 and 5.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from satae_torch.config import DataConfig
from satae_torch.data.augment import (augment_stacked_batch,
                                      augment_train_batch, draw_augmentation,
                                      draw_stacked_augmentation, normalize)
from satae_torch.models.mlp import MLP
from satae_torch.models.stacked import StackedMLP, StackedSupervisedAE
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn import layers as L
from satae_torch.nn.stacked import fold
from satae_torch.train.losses import (accuracy, cross_entropy, joint_ae_loss,
                                      stacked_accuracy, stacked_cross_entropy,
                                      stacked_joint_ae_loss)
from satae_torch.train.optim import AdamState, adam_update
from satae_torch.utils.profiling import check_finite, span

Metrics = Dict[str, torch.Tensor]
StepOut = Tuple[Metrics, Tuple[torch.Tensor, ...]]


def _grad_names(model: torch.nn.Module):
    return [f"gradient of {n}" for n, _ in model.named_parameters()]


def ae_train_step(model: SupervisedAE, opt: AdamState, imgs_u8: torch.Tensor,
                  labels: torch.Tensor, alpha: float, lr: float,
                  data_cfg: DataConfig, *,
                  generator: Optional[torch.Generator] = None,
                  flip: Optional[torch.Tensor] = None,
                  offsets: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  linear=L.linear,
                  dtype: torch.dtype = torch.float32,
                  mesh=None) -> StepOut:
    """One AE step on ``imgs_u8``; with ``mesh`` (satae_torch.parallel.Mesh)
    the data-parallel step on this rank's shard of a global batch: the
    augmentation draws are the global batch's (drawn from ``generator``,
    identical on every rank) sliced to this rank's rows, BatchNorm takes
    global-batch moments, and the gradients and metrics are the data axis's
    means, so every rank applies the same update."""
    if mesh is not None and flip is None:
        shape = (imgs_u8.shape[0] * mesh.data_size,) + imgs_u8.shape[1:]
        flip, offsets, noise = (
            None if d is None else mesh.shard(d) for d in draw_augmentation(
                shape, data_cfg.crop_padding, data_cfg.noise_std, generator,
                imgs_u8.device, dtype))
    imgs = augment_train_batch(imgs_u8, crop_padding=data_cfg.crop_padding,
                               noise_std=data_cfg.noise_std,
                               generator=generator, flip=flip,
                               offsets=offsets, noise=noise, dtype=dtype)
    model.train()
    with L.synced_batchnorm(mesh):
        x_hat, logits, _ = model(imgs, linear)
    total, mse, ce = joint_ae_loss(x_hat, logits, imgs, labels, alpha)
    check_finite("AE train step", ["loss"], [total])
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params)
    metrics = [total.detach(), mse.detach(), ce.detach(),
               accuracy(logits.detach(), labels)]
    if mesh is not None:
        grads = tuple(mesh.mean(grads))
        metrics = mesh.mean(metrics)
    check_finite("AE train step", _grad_names(model), grads)
    adam_update(params, grads, opt, lr)
    return dict(zip(("loss", "mse", "ce", "acc"), metrics)), grads


@torch.no_grad()
def ae_eval_step(model: SupervisedAE, imgs_u8: torch.Tensor,
                 labels: torch.Tensor, alpha: float,
                 dtype: torch.dtype = torch.float32) -> Metrics:
    imgs = normalize(imgs_u8, dtype)
    model.eval()
    x_hat, logits, _ = model(imgs)
    total, mse, ce = joint_ae_loss(x_hat, logits, imgs, labels, alpha)
    return {"loss": total, "mse": mse, "ce": ce,
            "acc": accuracy(logits, labels)}


def mlp_train_step(model: MLP, opt: AdamState, x: torch.Tensor,
                   labels: torch.Tensor, lr: float, weight_decay: float, *,
                   generator: Optional[torch.Generator] = None,
                   dropout_mask: Optional[torch.Tensor] = None,
                   linear=L.linear) -> StepOut:
    model.train()
    logits = model(x, dropout_mask, generator, linear)
    loss = cross_entropy(logits, labels)
    check_finite("MLP train step", ["loss"], [loss])
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    check_finite("MLP train step", _grad_names(model), grads)
    adam_update(params, grads, opt, lr, weight_decay=weight_decay)
    return ({"loss": loss.detach(),
             "acc": accuracy(logits.detach(), labels)}, grads)


@torch.no_grad()
def mlp_eval_step(model: MLP, x: torch.Tensor, labels: torch.Tensor
                  ) -> Metrics:
    model.eval()
    logits = model(x)
    return {"loss": cross_entropy(logits, labels),
            "acc": accuracy(logits, labels)}


@torch.no_grad()
def mlp_predict(model: MLP, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode class ids."""
    model.eval()
    return torch.argmax(model(x), dim=-1)


# ---- config-batched steps (the vmap sweep engine) ---------------------------

def stacked_ae_train_step(model: StackedSupervisedAE, opt: AdamState,
                          imgs_u8: torch.Tensor, labels: torch.Tensor,
                          alphas: torch.Tensor, lrs: torch.Tensor,
                          data_cfg: DataConfig, *,
                          generator: Optional[torch.Generator] = None,
                          flip: Optional[torch.Tensor] = None,
                          offsets: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None,
                          dtype: torch.dtype = torch.float32) -> StepOut:
    """One AE step of every config on the shared batch ``imgs_u8``
    (B, H, W, ch); the draws are drawn from ``generator``
    (satae_torch.data.augment.draw_stacked_augmentation) unless passed.

    Under a profiler the step is the span ``satae.train.step`` around the
    spans of its phases, each timed on the card too
    (satae_torch.utils.profiling.span): ``satae.train.forward`` (draws,
    augmentation, the model, the loss), ``satae.train.backward`` and
    ``satae.train.adam``."""
    on_card = imgs_u8.is_cuda
    with span("satae.train.step"):
        with span("satae.train.forward", device=on_card):
            if flip is None:
                flip, offsets, noise = draw_stacked_augmentation(
                    model.n_configs, imgs_u8.shape, data_cfg.crop_padding,
                    generator, imgs_u8.device, dtype)
            x = fold(augment_stacked_batch(
                imgs_u8, flip, offsets, noise,
                crop_padding=data_cfg.crop_padding,
                noise_std=data_cfg.noise_std, dtype=dtype))
            model.train()
            x_hat, logits, _ = model(x)
            total, mse, ce = stacked_joint_ae_loss(x_hat, logits, x, labels,
                                                   alphas)
        check_finite("stacked AE train step", ["loss"], [total])
        params = list(model.parameters())
        with span("satae.train.backward", device=on_card):
            grads = torch.autograd.grad(total.sum(), params)
        check_finite("stacked AE train step", _grad_names(model), grads)
        with span("satae.train.adam", device=on_card):
            adam_update(params, grads, opt, lrs)
        return ({"loss": total.detach(), "mse": mse.detach(),
                 "ce": ce.detach(),
                 "acc": stacked_accuracy(logits.detach(), labels)}, grads)


def stacked_mlp_train_step(model: StackedMLP, opt: AdamState,
                           x: torch.Tensor, labels: torch.Tensor,
                           lrs: torch.Tensor, weight_decay: float, *,
                           generator: Optional[torch.Generator] = None,
                           dropout_mask: Optional[torch.Tensor] = None
                           ) -> StepOut:
    """One MLP step of every config on the shared batch x (B, D); the
    dropout keep mask (C, B, hidden[0]) is drawn from ``generator`` unless
    passed."""
    model.train()
    xs = x.unsqueeze(0).expand(model.n_configs, -1, -1)
    logits = model(xs, dropout_mask, generator)
    loss = stacked_cross_entropy(logits, labels)
    check_finite("stacked MLP train step", ["loss"], [loss])
    params = list(model.parameters())
    grads = torch.autograd.grad(loss.sum(), params)
    check_finite("stacked MLP train step", _grad_names(model), grads)
    adam_update(params, grads, opt, lrs, weight_decay=weight_decay)
    return ({"loss": loss.detach(),
             "acc": stacked_accuracy(logits.detach(), labels)}, grads)
