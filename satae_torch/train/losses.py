"""Losses: the counterpart of satae/train/losses.py.

``alpha * MSE(x_hat, augmented x) + CE``: the reconstruction target is the
augmented (noisy) input, as in the reference. Every reduction accumulates in
float32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def mse_loss(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements (torch MSELoss 'mean')."""
    d = (x_hat - x).float()
    return torch.mean(d * d)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy from integer labels."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - true_logit)


def joint_ae_loss(x_hat: torch.Tensor, logits: torch.Tensor,
                  imgs: torch.Tensor, labels: torch.Tensor, alpha: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (total, mse, ce): total = alpha * mse + ce."""
    mse = mse_loss(x_hat, imgs)
    ce = cross_entropy(logits, labels)
    return alpha * mse + ce, mse, ce


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


# ---- config-batched (the vmap sweep engine) ---------------------------------

def stacked_joint_ae_loss(x_hat: torch.Tensor, logits: torch.Tensor,
                          imgs: torch.Tensor, labels: torch.Tensor,
                          alphas: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`joint_ae_loss` of every config, reduced over its batch only:
    x_hat and imgs folded (B, C*ch, H, W), logits (C, B, classes), labels
    (B,) shared, alphas (C,) -> (total, mse, ce), each (C,)."""
    c = logits.shape[0]
    d = (x_hat - imgs).float()
    mse = (d * d).reshape(d.shape[0], c, -1).mean((0, 2))
    ce = stacked_cross_entropy(logits, labels)
    return alphas * mse + ce, mse, ce


def stacked_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy per config: logits (C, B, classes), labels (B,)
    -> (C,)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    idx = labels.long()[None, :, None].expand(logits.shape[0], -1, 1)
    return torch.mean(logz - logits.gather(-1, idx)[..., 0], dim=1)


def stacked_accuracy(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Accuracy per config: logits (C, B, classes), labels (B,) -> (C,)."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float(), dim=1)
