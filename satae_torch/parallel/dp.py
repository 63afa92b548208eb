"""Data-parallel steps over a mesh: the counterpart of
satae/parallel/dp.py.

satae jits its single-device step bodies with the batch sharded on axis 0
and the state replicated, and XLA emits the gradient and BatchNorm
reductions. Here each rank runs the same step body on its shard
(satae_torch.train.steps with ``mesh``) and the reductions are explicit
collectives over the mesh's data axis: the train step's BatchNorm moments
and its gradients and metrics, the eval steps' sums. The encode and
decode steps run this rank's rows through the port's kernel path
(satae_torch.models.fast_infer, the decoder of
satae_torch.train.extract.make_decode_step) and all-gather the result;
satae's mesh path runs XLA there (api.py:502-505).

Every step takes this rank's rows (satae_torch.parallel.shard_batch of the
global batch), except encode and decode, which take the whole batch (its
length a multiple of the data axis) and return the whole result.
"""

from __future__ import annotations

from typing import Callable

import torch

from satae_torch.config import DataConfig
from satae_torch.data.augment import normalize
from satae_torch.models import fast_infer
from satae_torch.models.decoder import Decoder
from satae_torch.parallel.mesh import Mesh
from satae_torch.train import hbm
from satae_torch.train.extract import make_decode_step
from satae_torch.train.steps import ae_train_step


def make_dp_ae_train_step(mesh: Mesh, data_cfg: DataConfig,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> Callable:
    """``step(model, opt, imgs_u8, labels, alpha, lr, **draws)`` on this
    rank's rows of a global batch: satae_torch.train.steps.ae_train_step
    with ``mesh`` (global-batch BatchNorm, gradients and metrics averaged
    over the data axis, the global batch's augmentation draws)."""

    def step(model, opt, imgs_u8, labels, alpha, lr, **kw):
        return ae_train_step(model, opt, imgs_u8, labels, alpha, lr,
                             data_cfg, dtype=compute_dtype, mesh=mesh, **kw)

    return step


def make_dp_ae_eval_step(mesh: Mesh,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Callable:
    """``eval(model, imgs_u8, labels, alpha)`` on this rank's rows -> the
    global batch's means {loss, mse, ce, acc}: satae's unweighted DP eval
    (dp.py:39-48), which is satae_torch.train.steps.ae_eval_step on the
    whole batch. Each rank's sums with unit weights are summed over the
    data axis and divided by the global row count."""

    @torch.no_grad()
    def step(model, imgs_u8, labels, alpha):
        model.eval()
        ones = torch.ones(len(labels), device=imgs_u8.device)
        sums = hbm.all_reduced(hbm.ae_eval_batch_sums(
            model, imgs_u8, labels, ones, alpha, compute_dtype), mesh)
        n = sums.pop("n")
        return {k: v / n for k, v in sums.items()}

    return step


def make_dp_ae_eval_step_weighted(mesh: Mesh,
                                  compute_dtype: torch.dtype = torch.float32
                                  ) -> Callable:
    """``eval(model, imgs_u8, labels, weights, alpha)`` on this rank's rows
    -> the global batch's weighted sums {loss, mse, ce, acc, n}, summed over
    the data axis: zero-weight padding rows make any batch divide over the
    devices without biasing the metrics (satae's dp.py:50-77)."""

    @torch.no_grad()
    def step(model, imgs_u8, labels, weights, alpha):
        model.eval()
        return hbm.all_reduced(hbm.ae_eval_batch_sums(
            model, imgs_u8, labels, weights, alpha, compute_dtype), mesh)

    return step


def make_dp_encode_step(mesh: Mesh,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> Callable:
    """``encode(fe, imgs_u8)`` -> latents of the whole batch: this rank's
    rows through the folded encoder ``fe`` (fast_infer: K2 per conv layer
    and K1 for the projection on the card), all-gathered."""

    @torch.no_grad()
    def encode(fe: fast_infer.FoldedEncoder, imgs_u8: torch.Tensor):
        z = fast_infer.encoder_infer(
            fe, normalize(mesh.shard(imgs_u8), compute_dtype))
        return mesh.gather_rows(z)

    return encode


def make_dp_decode_step(mesh: Mesh, dec: Decoder,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> Callable:
    """``decode(z)`` -> float32 images of the whole batch: this rank's rows
    through ``dec`` (make_decode_step: its input linear one K1 launch on
    the card), all-gathered. Embarrassingly parallel."""
    local = make_decode_step(dec, compute_dtype)
    return lambda z: mesh.gather_rows(local(mesh.shard(z)))
