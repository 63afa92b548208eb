"""The weight carry-over: satae's parameter trees -> the reference state_dicts.

The port's own copy of satae/io/torch_export.py (``sae_to_torch_state_dict``,
``mlp_to_torch_state_dict``): it reads the numpy trees that
:mod:`satae_torch.io.checkpoint` restores from satae's ``.msgpack``
checkpoints and returns the reference ``SupervisedAutoencoder`` / ``MLP``
state_dict layout that the port's modules load ``strict=True``:

  * conv weights: HWIO -> OIHW;
  * transposed-conv weights: satae keeps the spatially flipped
    equivalent-forward kernel (kh, kw, in, out) -> unflip and transpose to
    ConvTranspose2d's (in, out, kh, kw);
  * linear weights: (in, out) -> (out, in);
  * the two flatten-boundary projections: satae flattens NHWC, the reference
    NCHW, so the encoder projection's input dim and the decoder projection's
    output dim (and its bias) are reindexed from (H, W, C) to (C, H, W);
  * BatchNorm: scale/bias -> weight/bias, mean/var -> running_mean/var, and
    ``num_batches_tracked`` 0 (int64) so a strict load accepts the dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from satae_torch.config import ModelConfig

Params = Mapping[str, Any]
StateDict = Dict[str, np.ndarray]


def _np(v: Any) -> np.ndarray:
    return np.asarray(v, np.float32)


def _linear(out: StateDict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).T
    out[f"{prefix}.bias"] = _np(p["b"])


def _bn(out: StateDict, prefix: str, p: Params, s: Params) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])
    out[f"{prefix}.running_mean"] = _np(s["mean"])
    out[f"{prefix}.running_var"] = _np(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def sae_to_torch_state_dict(params: Params, state: Params, cfg: ModelConfig,
                            image_size: int = 64) -> StateDict:
    """satae supervised-AE ``(params, bn_state)`` trees -> the reference
    ``SupervisedAutoencoder.state_dict()`` layout (numpy leaves)."""
    n = len(cfg.encoder_channels)
    spatial = image_size // (2 ** n)
    c_last = cfg.encoder_channels[-1]
    sd: StateDict = {}

    enc_p, enc_s = params["encoder"], state["encoder"]
    for i in range(n):
        w = _np(enc_p[f"conv{i}"]["w"])  # (kh, kw, I, O)
        sd[f"enc.encoder.{3 * i}.weight"] = w.transpose(3, 2, 0, 1)
        sd[f"enc.encoder.{3 * i}.bias"] = _np(enc_p[f"conv{i}"]["b"])
        _bn(sd, f"enc.encoder.{3 * i + 1}", enc_p[f"bn{i}"], enc_s[f"bn{i}"])
    # encoder projection: (H*W*C, latent) -> input rows in CHW order,
    # transposed to (latent, C*H*W)
    w = _np(enc_p["proj"]["w"]).T
    w = w.reshape(-1, spatial, spatial, c_last).transpose(0, 3, 1, 2)
    sd[f"enc.encoder.{3 * n + 1}.weight"] = w.reshape(w.shape[0], -1)
    sd[f"enc.encoder.{3 * n + 1}.bias"] = _np(enc_p["proj"]["b"])

    rev = tuple(reversed(cfg.encoder_channels))
    dec_p, dec_s = params["decoder"], state["decoder"]
    # decoder projection: (latent, H*W*C) -> output rows (and bias) in CHW
    # order, giving (C*H*W, latent)
    w = _np(dec_p["proj"]["w"]).T
    w = w.reshape(spatial, spatial, rev[0], -1).transpose(2, 0, 1, 3)
    sd["dec.decoder_input.weight"] = w.reshape(-1, w.shape[-1])
    b = _np(dec_p["proj"]["b"]).reshape(spatial, spatial, rev[0])
    sd["dec.decoder_input.bias"] = b.transpose(2, 0, 1).reshape(-1)

    for i in range(n):
        w = _np(dec_p[f"deconv{i}"]["w"])  # flipped-forward (kh, kw, I, O)
        sd[f"dec.decoder.{3 * i + 1}.weight"] = np.ascontiguousarray(
            w[::-1, ::-1].transpose(2, 3, 0, 1))
        sd[f"dec.decoder.{3 * i + 1}.bias"] = _np(dec_p[f"deconv{i}"]["b"])
        if i < n - 1:
            _bn(sd, f"dec.decoder.{3 * i + 2}", dec_p[f"bn{i}"],
                dec_s[f"bn{i}"])

    _linear(sd, "classifier.0", params["head"]["fc1"])
    _linear(sd, "classifier.2", params["head"]["fc2"])
    return sd


def mlp_to_torch_state_dict(params: Params, state: Params, cfg: ModelConfig
                            ) -> StateDict:
    """satae MLP trees -> the reference ``MLP.state_dict()`` layout."""
    sd: StateDict = {}
    idx = 0
    for i in range(len(cfg.mlp_hidden)):
        _linear(sd, f"net.{idx}", params[f"fc{i}"])
        _bn(sd, f"net.{idx + 1}", params[f"bn{i}"], state[f"bn{i}"])
        # Linear, BN, ReLU (+ Dropout after the first hidden block only)
        idx += 4 if i == 0 else 3
    _linear(sd, f"net.{idx}", params[f"fc{len(cfg.mlp_hidden)}"])
    return sd


def to_tensors(sd: StateDict) -> Dict[str, torch.Tensor]:
    """numpy state_dict -> torch tensors (copies, so leaves may be views)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
