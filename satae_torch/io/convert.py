"""The weight carry-over between satae's parameter trees and the reference
state_dicts, both ways.

Forward, the port's own copy of satae/io/torch_export.py
(``sae_to_torch_state_dict``, ``mlp_to_torch_state_dict``): it reads the
numpy trees that :mod:`satae_torch.io.checkpoint` restores from satae's
``.msgpack`` checkpoints and returns the reference ``SupervisedAutoencoder``
/ ``MLP`` state_dict layout that the port's modules load ``strict=True``.
Back, the port's own copy of satae/io/torch_import.py
(``sae_from_torch_state_dict``, ``mlp_from_torch_state_dict``): a state_dict
(tensors on any device, or numpy) -> satae's ``(params, bn_state)`` trees,
which the port writes as checkpoints. Both ways are transposes and
reindexing only, so a round trip is exact. The forward mapping:

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

The way back undoes each of these and drops ``num_batches_tracked`` (the
BatchNorm momentum is a constant 0.1, so the counter changes nothing).

Adam's moments have their parameters' shapes, and every map above is a
transpose or a reindexing, so they travel the same way
(:func:`opt_state_to_tree`, :func:`opt_state_from_tree`): the port keeps
them as lists in ``named_parameters`` order, satae as
``{"mu": params tree, "nu": params tree, "step": int32}``
(satae/train/optim.py:21-27).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from satae_torch.config import ModelConfig

Params = Mapping[str, Any]
StateDict = Dict[str, np.ndarray]


def _np(v: Any) -> np.ndarray:
    """A tensor on any device, or array-like -> float32 numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
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


def _linear_back(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {"w": _np(sd[f"{prefix}.weight"]).T,
            "b": _np(sd[f"{prefix}.bias"])}


def _bn_back(sd: Mapping[str, Any], prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    state = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, state


def sae_from_torch_state_dict(sd: Mapping[str, Any], cfg: ModelConfig,
                              in_ch: int = 3, image_size: int = 64
                              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The reference ``SupervisedAutoencoder.state_dict()`` layout ->
    satae's supervised-AE ``(params, bn_state)`` numpy trees."""
    n = len(cfg.encoder_channels)
    spatial = image_size // (2 ** n)
    c_last = cfg.encoder_channels[-1]
    got_in = int(_np(sd["enc.encoder.0.weight"]).shape[1])
    if got_in != in_ch:
        raise ValueError(
            f"state_dict expects {got_in} input channels, caller declared "
            f"{in_ch}: wrong checkpoint for this data config")

    enc_p: Dict[str, Any] = {}
    enc_s: Dict[str, Any] = {}
    for i in range(n):
        w = _np(sd[f"enc.encoder.{3 * i}.weight"])  # (O, I, kh, kw)
        enc_p[f"conv{i}"] = {"w": w.transpose(2, 3, 1, 0),
                             "b": _np(sd[f"enc.encoder.{3 * i}.bias"])}
        enc_p[f"bn{i}"], enc_s[f"bn{i}"] = _bn_back(
            sd, f"enc.encoder.{3 * i + 1}")
    # encoder projection: (latent, C*H*W) -> input rows in HWC order,
    # transposed to (H*W*C, latent)
    w = _np(sd[f"enc.encoder.{3 * n + 1}.weight"])
    w = w.reshape(-1, c_last, spatial, spatial).transpose(0, 2, 3, 1)
    enc_p["proj"] = {"w": w.reshape(w.shape[0], -1).T,
                     "b": _np(sd[f"enc.encoder.{3 * n + 1}.bias"])}

    rev = tuple(reversed(cfg.encoder_channels))
    dec_p: Dict[str, Any] = {}
    dec_s: Dict[str, Any] = {}
    # decoder projection: (C*H*W, latent) -> output rows (and bias) in HWC
    # order, transposed to (latent, H*W*C)
    w = _np(sd["dec.decoder_input.weight"])
    w = w.reshape(rev[0], spatial, spatial, -1).transpose(1, 2, 0, 3)
    b = _np(sd["dec.decoder_input.bias"])
    b = b.reshape(rev[0], spatial, spatial).transpose(1, 2, 0).reshape(-1)
    dec_p["proj"] = {"w": w.reshape(-1, w.shape[-1]).T, "b": b}

    for i in range(n):
        w = _np(sd[f"dec.decoder.{3 * i + 1}.weight"])  # (I, O, kh, kw)
        # satae keeps the flipped equivalent-forward kernel (kh, kw, I, O)
        dec_p[f"deconv{i}"] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1]),
            "b": _np(sd[f"dec.decoder.{3 * i + 1}.bias"]),
        }
        if i < n - 1:
            dec_p[f"bn{i}"], dec_s[f"bn{i}"] = _bn_back(
                sd, f"dec.decoder.{3 * i + 2}")

    params = {"encoder": enc_p, "decoder": dec_p,
              "head": {"fc1": _linear_back(sd, "classifier.0"),
                       "fc2": _linear_back(sd, "classifier.2")}}
    return params, {"encoder": enc_s, "decoder": dec_s}


def mlp_from_torch_state_dict(sd: Mapping[str, Any], cfg: ModelConfig
                              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The reference ``MLP.state_dict()`` layout -> satae's MLP trees."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    idx = 0
    for i in range(len(cfg.mlp_hidden)):
        params[f"fc{i}"] = _linear_back(sd, f"net.{idx}")
        params[f"bn{i}"], state[f"bn{i}"] = _bn_back(sd, f"net.{idx + 1}")
        idx += 4 if i == 0 else 3
    params[f"fc{len(cfg.mlp_hidden)}"] = _linear_back(sd, f"net.{idx}")
    return params, state


def to_tensors(sd: StateDict) -> Dict[str, torch.Tensor]:
    """numpy state_dict -> torch tensors (copies, so leaves may be views)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def opt_state_to_tree(names: Sequence[str], mu: Sequence[Any],
                      nu: Sequence[Any], step: int,
                      state_dict: Mapping[str, Any],
                      to_trees: Callable[[Mapping[str, Any]], Tuple[Any, Any]]
                      ) -> Dict[str, Any]:
    """Adam's moments of the parameters ``names`` (the model's, in order) ->
    satae's ``OptState`` tree. ``to_trees`` is the model's state_dict ->
    trees map; ``state_dict`` fills the buffers it also reads."""
    tree = lambda ms: to_trees({**state_dict, **dict(zip(names, ms))})[0]
    return {"mu": tree(mu), "nu": tree(nu),
            "step": np.asarray(step, np.int32)}


def opt_state_from_tree(tree: Mapping[str, Any], bn_state: Any,
                        names: Sequence[str],
                        from_trees: Callable[[Any, Any], Mapping[str, Any]]
                        ) -> Tuple[List[Any], List[Any], int]:
    """satae's ``OptState`` tree -> (mu, nu, step), the moments in the
    order of ``names``; ``from_trees`` is the trees -> state_dict map and
    ``bn_state`` the BatchNorm tree it also reads."""
    mu, nu = (from_trees(tree[k], bn_state) for k in ("mu", "nu"))
    return [mu[n] for n in names], [nu[n] for n in names], int(tree["step"])
