"""Frozen-encoder latent extraction: the counterpart of
satae/train/extract.py's ``extract_features``.

The split is uploaded once, zero-padded on the device to whole chunks, and
encoded chunk by chunk through the serving path of satae_torch.models.
fast_infer (BatchNorm and bias folded once; on a CUDA device one K2 launch
per conv layer and one K1 launch for the projection per chunk, on the CPU
their plain versions). The chunk follows satae's rule (extract.py:76-80):
at least ``batch_size`` and 2048 images, but never past the split rounded up
to a whole batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from satae_torch.data.augment import normalize
from satae_torch.data.pipeline import ArrayDataset
from satae_torch.models import fast_infer
from satae_torch.models.encoder import Encoder


def extract_chunk(n: int, batch_size: int) -> int:
    return min(max(batch_size, 2048), -(-n // batch_size) * batch_size)


@torch.no_grad()
def extract_features(enc: Encoder, ds: ArrayDataset, batch_size: int = 64
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (N, latent_dim) float32, y (N,) int32) on the host, from
    ``enc`` on its own device in eval mode."""
    device = next(enc.parameters()).device
    n = len(ds)
    if n == 0:
        return (np.zeros((0, enc.proj.out_features), np.float32),
                np.asarray(ds.labels, np.int32))
    chunk = extract_chunk(n, batch_size)
    pad = (-n) % chunk
    imgs = torch.zeros((n + pad,) + ds.images.shape[1:], dtype=torch.uint8,
                       device=device)
    imgs[:n].copy_(torch.from_numpy(np.ascontiguousarray(ds.images)))
    fe = fast_infer.fold_encoder(enc)
    zs = [fast_infer.encoder_infer(fe, normalize(imgs[lo:lo + chunk]))
          for lo in range(0, n + pad, chunk)]
    X = torch.cat(zs)[:n].cpu().numpy()
    return X, np.asarray(ds.labels, np.int32)
