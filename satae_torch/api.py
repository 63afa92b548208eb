"""Public serving API: the counterpart of satae/api.py's inference surface.

``SatAEPipeline`` loads a fitted pipeline (satae's ``.msgpack`` run
directory, or the reference notebook's ``.pt`` state_dicts) and serves
``encode``, ``predict`` and ``predict_proba`` through the fixed-chunk bulk
path of satae (api.py:527-603): one upload, chunks of 64 images for inputs of
up to 64, of 512 otherwise, padding rows sliced off.

The device is explicit. ``device=None`` means the first CUDA device, and
raises where there is none: the pipeline never drops to the CPU by itself.
On a CUDA device every chunk runs satae_torch.models.fast_infer on the
hand-written kernels (K2 per conv layer, K1 per linear layer); there is no
switch to a plain path there. With ``device="cpu"`` the same code runs the
kernels' plain PyTorch versions.

Training (``fit``), ``evaluate``, ``save``, export, decoder serving
(``decode``/``reconstruct``), bf16 compute and multi-device serving are
later slices (ROADMAP.md §1).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from satae_torch.config import PipelineConfig, default_config
from satae_torch.data.augment import normalize
from satae_torch.io import checkpoint, convert
from satae_torch.models import fast_infer
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` if a card is present, else raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: satae_torch serves on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class SatAEPipeline:
    """Loaded autoencoder + MLP, served on ``device`` through the kernels."""

    def __init__(self, config: Optional[PipelineConfig] = None, device=None):
        self.config = config or default_config()
        rt = self.config.runtime
        if rt.compute_dtype != "float32":
            raise NotImplementedError(
                "satae_torch serves in float32 only: bf16 inputs to the "
                "kernels are a later slice (ROADMAP.md §1 item 12, §2)")
        if rt.n_devices:
            raise NotImplementedError(
                "multi-device serving is a later slice (ROADMAP.md §1 "
                "item 13)")
        self.device = resolve_device(device)
        self.ae: Optional[SupervisedAE] = None
        self.mlp: Optional[MLP] = None
        self.classes = None
        self._folded = None
        self._folded_src = None

    # -- loading -----------------------------------------------------------

    def _install(self, ae_sd, mlp_sd) -> None:
        d = self.config.data
        ae = SupervisedAE(self.config.model, d.channels, d.image_size)
        ae.load_state_dict(ae_sd, strict=True)
        self.ae = ae.to(self.device).eval()
        if mlp_sd is not None:
            mlp = MLP(self.config.model)
            mlp.load_state_dict(mlp_sd, strict=True)
            self.mlp = mlp.to(self.device).eval()
        else:
            self.mlp = None

    def load(self, out_dir: str) -> "SatAEPipeline":
        """Load a satae run directory (``ae_global_best.msgpack`` +
        ``mlp_global_best.msgpack``, optional ``classes.json``)."""
        ae_file = Path(out_dir) / "ae_global_best.msgpack"
        mlp_file = Path(out_dir) / "mlp_global_best.msgpack"
        missing = [str(p) for p in (ae_file, mlp_file) if not p.exists()]
        if missing:
            raise FileNotFoundError(
                f"no fitted pipeline under {out_dir!r} (missing: "
                f"{', '.join(missing)})")
        cfg = self.config
        ae_p, ae_s = checkpoint.load_model(ae_file)
        mlp_p, mlp_s = checkpoint.load_model(mlp_file)
        self._install(
            convert.to_tensors(convert.sae_to_torch_state_dict(
                ae_p, ae_s, cfg.model, cfg.data.image_size)),
            convert.to_tensors(convert.mlp_to_torch_state_dict(
                mlp_p, mlp_s, cfg.model)))
        classes_file = Path(out_dir) / "classes.json"
        if classes_file.exists():
            self.classes = tuple(json.loads(classes_file.read_text()))
        return self

    def load_torch(self, ae_pt: str,
                   mlp_pt: Optional[str] = None) -> "SatAEPipeline":
        """Load the reference notebook's ``AE_GLOBAL_BEST.pt`` (and
        ``MLP_GLOBAL_BEST.pt``) state_dicts, strictly."""
        load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
        self._install(load(ae_pt), None if mlp_pt is None else load(mlp_pt))
        return self

    # -- inference ---------------------------------------------------------

    @staticmethod
    def _to_uint8(images: np.ndarray) -> np.ndarray:
        """Accept uint8 images or floats in [0,1] (rounded back to the uint8
        grid). Floats on a 0-255 scale, or below 0, are rejected rather than
        silently saturated."""
        imgs = np.asarray(images)
        if imgs.dtype == np.uint8:
            return imgs
        mx = float(imgs.max(initial=0.0))
        if mx > 1.0 + 1e-3:
            raise ValueError(
                f"float images must be normalized to [0,1] (max={mx:.3g}); "
                "pass uint8 for raw 0-255 pixel values")
        mn = float(imgs.min(initial=0.0))
        if mn < -1e-3:
            raise ValueError(
                f"float images must be normalized to [0,1] (min={mn:.3g}); "
                "[-1,1]-standardized inputs would have every negative pixel "
                "silently clipped to 0")
        return np.rint(np.clip(imgs, 0.0, 1.0) * 255.0).astype(np.uint8)

    def _require_fitted(self, mlp: bool = False) -> None:
        if self.ae is None:
            raise RuntimeError("pipeline is not loaded — call load() or "
                               "load_torch()")
        if mlp and self.mlp is None:
            raise RuntimeError("no classifier: only the autoencoder is "
                               "loaded (load_torch without mlp_pt)")

    def _folded_weights(self):
        """Folded, packed weights for the kernels, computed once per weight
        set: refreshed when ``ae``/``mlp`` are reassigned or their tensors
        change in place (``load_state_dict`` bumps their versions)."""
        versions = tuple((t.data_ptr(), t._version)
                         for m in (self.ae, self.mlp) if m is not None
                         for t in m.state_dict().values())
        src = self._folded_src
        if src is None or src[0] is not self.ae or src[1] is not self.mlp \
                or src[2] != versions:
            self._folded = (
                fast_infer.fold_encoder(self.ae.enc),
                None if self.mlp is None else fast_infer.fold_mlp(self.mlp))
            self._folded_src = (self.ae, self.mlp, versions)
        return self._folded

    def _serve_chunk(self, n: int) -> int:
        """Fixed chunk: one training batch for small inputs, eight otherwise
        (64 / 512 at the default config), as satae's ``_serve_chunk``."""
        bs = self.config.data.batch_size
        return bs if n <= bs else bs * 8

    @torch.no_grad()
    def _serve_batched(self, images: np.ndarray, fe: fast_infer.FoldedEncoder,
                       head: Callable[[torch.Tensor], torch.Tensor]
                       ) -> List[torch.Tensor]:
        """One upload, padded on the device to whole fixed-size chunks,
        latents chained into ``head`` on the device. Returns per-chunk
        outputs covering n + pad rows (padding rows never mix with real
        ones: eval-mode BN uses running stats, every layer is per image)."""
        imgs = self._to_uint8(np.asarray(images))
        n = len(imgs)
        chunk = self._serve_chunk(n)
        pad = (-n) % chunk
        dev = torch.zeros((n + pad,) + imgs.shape[1:], dtype=torch.uint8,
                          device=self.device)
        dev[:n].copy_(torch.from_numpy(np.ascontiguousarray(imgs)))
        out = []
        for lo in range(0, n + pad, chunk):
            z = fast_infer.encoder_infer(fe, normalize(dev[lo:lo + chunk]))
            out.append(head(z))
        return out

    def encode(self, images: np.ndarray) -> np.ndarray:
        """uint8 images or floats in [0,1], (N,H,W,C) -> (N, latent_dim)
        float32, through the fixed-chunk path (:meth:`encode_batched`)."""
        return self.encode_batched(images)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Images -> predicted class ids (int32), through encoder + MLP."""
        return self.predict_batched(images)

    def predict_proba(self, images: np.ndarray) -> np.ndarray:
        """Images -> per-class probabilities (softmax over the MLP logits),
        (N, num_classes) float32."""
        return self.predict_proba_batched(images)

    def encode_batched(self, images: np.ndarray) -> np.ndarray:
        self._require_fitted()
        n = len(np.asarray(images))
        if n == 0:
            return np.zeros((0, self.config.model.latent_dim), np.float32)
        fe, _ = self._folded_weights()
        zs = self._serve_batched(images, fe, lambda z: z)
        return torch.cat(zs).cpu().numpy()[:n]

    def predict_batched(self, images: np.ndarray) -> np.ndarray:
        self._require_fitted(mlp=True)
        n = len(np.asarray(images))
        if n == 0:
            return np.zeros((0,), np.int32)
        fe, fm = self._folded_weights()
        preds = self._serve_batched(
            images, fe,
            lambda z: torch.argmax(fast_infer.mlp_infer(fm, z), dim=-1))
        return torch.cat(preds).to(torch.int32).cpu().numpy()[:n]

    def predict_proba_batched(self, images: np.ndarray) -> np.ndarray:
        self._require_fitted(mlp=True)
        n = len(np.asarray(images))
        if n == 0:
            return np.zeros((0, self.config.model.num_classes), np.float32)
        fe, fm = self._folded_weights()
        probs = self._serve_batched(
            images, fe,
            lambda z: torch.softmax(fast_infer.mlp_infer(fm, z), dim=-1))
        return torch.cat(probs).cpu().numpy()[:n]

