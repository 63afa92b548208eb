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
