"""Input transforms: the counterpart of satae/data/augment.py.

The training augmentation is the reference's: horizontal flip with p = 0.5,
zero-pad 4 and a random crop back to the image size (offsets uniform in
[0, 2p]), the uint8 -> [0, 1] scaling, and unclamped additive N(0, 0.03)
noise. The deterministic core :func:`flip_crop` takes the flips and offsets
as inputs and indexes the padded batch directly; satae's selection-matmul
form of the same map is a TPU device choice.

The random draws come from a ``torch.Generator``, so they are not satae's
(JAX's threefry or rbg streams); the flips, offsets and noise can be passed
in to reproduce a given draw. With a bf16 ``dtype`` the scaling, the crop,
the noise (drawn in bf16, as satae draws it, augment.py:84-93) and its
scale run in bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from satae_torch.nn.layers import const_like


def normalize(imgs_u8: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (N,H,W,C) -> float [0,1], the same division as satae's."""
    return imgs_u8.to(dtype) / 255.0


def flip_crop(x: torch.Tensor, flip: torch.Tensor, offsets: torch.Tensor,
              crop_padding: int) -> torch.Tensor:
    """Flip the images of x (N,H,W,C) where ``flip`` (bool, (N,) or (N,1)),
    zero-pad by ``crop_padding`` and crop the (H, W) window at ``offsets``
    (int (N, 2), (off_y, off_x) in [0, 2p]). The same map as satae's
    ``flip_crop_select``, whose flip folds into the column index because
    zero padding is symmetric."""
    n, h, w, _ = x.shape
    p = crop_padding
    padded = F.pad(x, (0, 0, p, p, p, p))
    offsets = offsets.to(device=x.device, dtype=torch.long)
    iy = offsets[:, 0:1] + torch.arange(h, device=x.device)  # (N, H)
    jx = offsets[:, 1:2] + torch.arange(w, device=x.device)  # (N, W)
    jx = torch.where(flip.reshape(n, 1).to(x.device), (w + 2 * p - 1) - jx,
                     jx)
    rows = torch.arange(n, device=x.device)[:, None, None]
    return padded[rows, iy[:, :, None], jx[:, None, :]]


def augment_train_batch(imgs_u8: torch.Tensor, *, crop_padding: int = 4,
                        noise_std: float = 0.03,
                        generator: Optional[torch.Generator] = None,
                        flip: Optional[torch.Tensor] = None,
                        offsets: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (N,H,W,C) -> augmented (N,H,W,C) in ``dtype``, ~[0,1]
    (+noise).

    ``flip`` (bernoulli(0.5) per image), ``offsets`` (uniform integers in
    [0, 2 * crop_padding]) and ``noise`` (standard normal, the batch's
    shape, cast to ``dtype``) are drawn from ``generator`` on the batch's
    device unless given."""
    n = imgs_u8.shape[0]
    dev = imgs_u8.device
    if flip is None:
        flip = torch.rand((n, 1), generator=generator, device=dev) < 0.5
    if offsets is None:
        offsets = torch.randint(0, 2 * crop_padding + 1, (n, 2),
                                generator=generator, device=dev)
    x = flip_crop(normalize(imgs_u8, dtype), flip, offsets, crop_padding)
    if noise_std:
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=dev,
                                dtype=dtype)
        x = x + const_like(noise_std, x) * noise.to(device=dev, dtype=dtype)
    return x


def draw_stacked_augmentation(n_configs: int, shape, crop_padding: int,
                              generator: Optional[torch.Generator], device,
                              dtype: torch.dtype = torch.float32):
    """The random inputs of a config-batched batch of ``shape`` (B, H, W,
    ch): flips (C, B, 1), offsets (C, B, 2) and noise (C, B, H, W, ch) in
    ``dtype``, drawn from ``generator`` in that order, one slice per config
    (satae's vmap engine draws each config's from its own key)."""
    c, b = n_configs, shape[0]
    flip = torch.rand((c, b, 1), generator=generator, device=device) < 0.5
    offsets = torch.randint(0, 2 * crop_padding + 1, (c, b, 2),
                            generator=generator, device=device)
    noise = torch.randn((c,) + tuple(shape), generator=generator,
                        device=device, dtype=dtype)
    return flip, offsets, noise


def augment_stacked_batch(imgs_u8: torch.Tensor, flip: torch.Tensor,
                          offsets: torch.Tensor, noise: torch.Tensor, *,
                          crop_padding: int = 4, noise_std: float = 0.03,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The shared uint8 batch (B, H, W, ch) augmented once per config with
    that config's flips (C, B, 1), offsets (C, B, 2) and noise
    (C, B, H, W, ch): :func:`augment_train_batch` of the batch repeated C
    times, as (C, B, H, W, ch) in ``dtype``."""
    c, b = flip.shape[:2]
    x = augment_train_batch(
        imgs_u8.repeat(c, 1, 1, 1), crop_padding=crop_padding,
        noise_std=noise_std, flip=flip.reshape(c * b, 1),
        offsets=offsets.reshape(c * b, 2),
        noise=noise.reshape((c * b,) + tuple(noise.shape[2:])), dtype=dtype)
    return x.reshape((c,) + tuple(imgs_u8.shape))
