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
update used, in ``model.parameters()`` order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from satae_torch.config import DataConfig
from satae_torch.data.augment import augment_train_batch, normalize
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn import layers as L
from satae_torch.train.losses import accuracy, cross_entropy, joint_ae_loss
from satae_torch.train.optim import AdamState, adam_update

Metrics = Dict[str, torch.Tensor]
StepOut = Tuple[Metrics, Tuple[torch.Tensor, ...]]


def ae_train_step(model: SupervisedAE, opt: AdamState, imgs_u8: torch.Tensor,
                  labels: torch.Tensor, alpha: float, lr: float,
                  data_cfg: DataConfig, *,
                  generator: Optional[torch.Generator] = None,
                  flip: Optional[torch.Tensor] = None,
                  offsets: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  linear=L.linear) -> StepOut:
    imgs = augment_train_batch(imgs_u8, crop_padding=data_cfg.crop_padding,
                               noise_std=data_cfg.noise_std,
                               generator=generator, flip=flip,
                               offsets=offsets, noise=noise)
    model.train()
    x_hat, logits, _ = model(imgs, linear)
    total, mse, ce = joint_ae_loss(x_hat, logits, imgs, labels, alpha)
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params)
    adam_update(params, grads, opt, lr)
    return ({"loss": total.detach(), "mse": mse.detach(), "ce": ce.detach(),
             "acc": accuracy(logits.detach(), labels)}, grads)


@torch.no_grad()
def ae_eval_step(model: SupervisedAE, imgs_u8: torch.Tensor,
                 labels: torch.Tensor, alpha: float) -> Metrics:
    imgs = normalize(imgs_u8)
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
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
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
