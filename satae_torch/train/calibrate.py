"""Loss-scale calibration (reference C14): the counterpart of
satae/train/calibrate.py.

The reference trains nothing here: it initialises many fresh models (1,000,
latent 128), runs one augmented training batch through each in train mode
and histograms ratio = CE / MSE, the scale that justifies alpha in [20, 40]
(~30-32). satae runs the inits as one sequential ``lax.scan``, not a vmap
(vmapped conv weights lower to grouped convolutions, calibrate.py:64-71);
here they are a plain loop over one model whose parameters are drawn again
for each init, on the device, from a generator of its own. The ratios stay
on the device and are read back once. On the card each forward is four K1
launches (encoder projection, decoder input, the head's two linears).

The draws are torch's, so the ratios are not satae's (its inits and
augmentation come from JAX's streams): the same experiment, the same
distribution, other samples. :func:`init_ratio` is one init's ratio on given
weights and batch, which is how the tests hold it against satae's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from satae_torch.config import DataConfig, ModelConfig
from satae_torch.data.augment import augment_train_batch
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn.init import init_
from satae_torch.nn.layers import float32_convs
from satae_torch.train.losses import cross_entropy, mse_loss


@torch.no_grad()
def init_ratio(model: SupervisedAE, imgs: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """CE / MSE of ``model``'s train-mode forward (batch statistics) on the
    augmented batch ``imgs`` (the reconstruction target), a 0-d tensor on
    the device; the convolutions in float32 (TF32 off) with cuDNN's
    deterministic algorithms, so an init's ratio repeats bit for bit."""
    model.train()
    with float32_convs(deterministic=True):
        x_hat, logits, _ = model(imgs)
    return cross_entropy(logits, labels) / mse_loss(x_hat, imgs)


def loss_ratio_calibration(
    imgs_u8: np.ndarray,
    labels: np.ndarray,
    *,
    model_cfg: Optional[ModelConfig] = None,
    data_cfg: Optional[DataConfig] = None,
    n_inits: int = 1000,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """The (n_inits,) CE/MSE ratios at initialisation, on ``device`` (None:
    the first CUDA device, as the pipeline resolves it). The model is the
    reference's calibration model, latent 128 by default; the batch is
    augmented once, from a generator seeded ``seed``; init i draws its
    weights from a generator seeded ``(seed + 1) * 2**32 + i``."""
    from satae_torch.api import resolve_device

    dev = resolve_device(device)
    model_cfg = model_cfg or ModelConfig(latent_dim=128)
    data_cfg = data_cfg or DataConfig()
    imgs = augment_train_batch(
        torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(dev),
        crop_padding=data_cfg.crop_padding, noise_std=data_cfg.noise_std,
        generator=torch.Generator(device=dev).manual_seed(seed))
    labels_d = torch.from_numpy(np.asarray(labels)).to(dev).long()
    model = SupervisedAE(model_cfg, imgs.shape[-1], imgs.shape[1]).to(dev)
    ratios = torch.empty(n_inits, device=dev)
    base = (seed + 1) << 32
    for i in range(n_inits):
        init_(model, torch.Generator(device=dev).manual_seed(base + i))
        ratios[i] = init_ratio(model, imgs, labels_d)
    return ratios.cpu().numpy()


@dataclasses.dataclass
class CalibrationSummary:
    median: float
    mean: float
    p5: float
    p95: float

    @classmethod
    def from_ratios(cls, ratios: np.ndarray) -> "CalibrationSummary":
        return cls(float(np.median(ratios)), float(np.mean(ratios)),
                   float(np.percentile(ratios, 5)),
                   float(np.percentile(ratios, 95)))
