"""Frozen-encoder latent extraction and the decoder's serving step: the
counterpart of satae/train/extract.py.

The split is uploaded once, zero-padded on the device to whole chunks, and
encoded chunk by chunk through the serving path of satae_torch.models.
fast_infer (BatchNorm and bias folded once; on a CUDA device one K2 launch
per conv layer and one K1 launch for the projection per chunk, on the CPU
their plain versions). The chunk follows satae's rule (extract.py:76-80):
at least ``batch_size`` and 2048 images, but never past the split rounded up
to a whole batch. With a bf16 ``compute_dtype`` the encoder runs in bf16
(bf16 K2 and K1) and the latents reach the host as float32, as satae's do
(extract.py:24-32, 92), for the float32 MLP. With ``mesh``
(satae_torch.parallel.Mesh) the chunk is rounded up to a multiple of the
data axis's devices (satae's ``pad_multiple``, extract.py:71) and each rank
encodes its rows of every chunk, all-gathered
(satae_torch.parallel.dp.make_dp_encode_step); the latents are the
single-device path's.

:func:`make_decode_step` is satae's: latents cast to the compute dtype at
entry, the eval-mode decoder (its input linear one K1 launch on the card,
its transposed convolutions ``F.conv_transpose2d``), images back as
float32.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from satae_torch.data.pipeline import ArrayDataset
from satae_torch.models import fast_infer
from satae_torch.models.decoder import Decoder
from satae_torch.models.encoder import Encoder


def extract_chunk(n: int, batch_size: int) -> int:
    return min(max(batch_size, 2048), -(-n // batch_size) * batch_size)


@torch.no_grad()
def extract_features(enc: Encoder, ds: ArrayDataset, batch_size: int = 64,
                     compute_dtype: torch.dtype = torch.float32, mesh=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (N, latent_dim) float32, y (N,) int32) on the host, from
    ``enc`` on its own device in eval mode, computing in
    ``compute_dtype``; sharded over ``mesh``'s data axis when given."""
    device = next(enc.parameters()).device
    n = len(ds)
    if n == 0:
        return (np.zeros((0, enc.proj.out_features), np.float32),
                np.asarray(ds.labels, np.int32))
    chunk = extract_chunk(n, batch_size)
    step = lambda fe, u8: fe(u8)
    if mesh is not None:
        from satae_torch.parallel.dp import make_dp_encode_step
        chunk = -(-chunk // mesh.data_size) * mesh.data_size
        step = make_dp_encode_step(mesh)
    pad = (-n) % chunk
    imgs = torch.zeros((n + pad,) + ds.images.shape[1:], dtype=torch.uint8,
                       device=device)
    imgs[:n].copy_(torch.from_numpy(np.ascontiguousarray(ds.images)))
    fe = fast_infer.fold_encoder(enc, compute_dtype)
    zs = [step(fe, imgs[lo:lo + chunk]) for lo in range(0, n + pad, chunk)]
    X = torch.cat(zs)[:n].float().cpu().numpy()
    return X, np.asarray(ds.labels, np.int32)


def make_decode_step(dec: Decoder,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Latents (N, latent_dim) on ``dec``'s device -> images (N, H, W, C)
    float32 in [0, 1], through ``dec`` (in eval mode, as the pipeline holds
    its modules) computing in ``compute_dtype`` (what the decoder saw in
    training: the encoder's activations in that dtype)."""

    @torch.no_grad()
    def decode(z: torch.Tensor) -> torch.Tensor:
        return dec(z.to(compute_dtype)).float()

    return decode
