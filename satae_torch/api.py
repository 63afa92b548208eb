"""Public API: the counterpart of satae/api.py's single-config fit and its
inference surface.

``SatAEPipeline.fit(grid=False)`` runs satae's single-config pipeline
(api.py:119-336): supervised-AE training at the reference-optimal alpha 35,
lr 5e-3 with patience-15 early stopping, frozen-encoder latent extraction,
MLP training at lr 1e-4 for ``MLPTrainConfig.epochs``, and the test-split
score. It trains in float32 with TF32 off for cuDNN. On a CUDA device every
linear layer's forward and backward runs on kernel K1, and extraction runs
on K2 + K1; the convolutions, transposed convolutions, BatchNorm, losses and
Adam are stock PyTorch ops, as they are XLA ops in satae.

``SatAEPipeline`` also loads a fitted pipeline (satae's ``.msgpack`` run
directory, or the reference notebook's ``.pt`` state_dicts) and serves
``encode``, ``predict`` and ``predict_proba`` through the fixed-chunk bulk
path of satae (api.py:527-603): one upload, chunks of 64 images for inputs of
up to 64, of 512 otherwise, padding rows sliced off. On a CUDA device every
chunk runs satae_torch.models.fast_infer on the hand-written kernels (K2 per
conv layer, K1 per linear layer); with ``device="cpu"`` the same code runs
the kernels' plain PyTorch versions.

The device is explicit. ``device=None`` means the first CUDA device, and
raises where there is none: the pipeline never drops to the CPU by itself.

The grid sweeps and ``out_dir`` checkpoints of ``fit``, ``evaluate``,
``save``, export, decoder serving (``decode``/``reconstruct``), bf16 compute
and multi-device runs are later slices (ROADMAP.md §1).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from satae_torch.config import PipelineConfig, default_config
from satae_torch.data.augment import normalize
from satae_torch.data.ingest import RawDataset, load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.io import checkpoint, convert
from satae_torch.models import fast_infer
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.train.extract import extract_features
from satae_torch.train.fast_loop import train_mlp, train_supervised_ae
from satae_torch.train.loop import LogFn

# Reference-optimal single-config hyperparameters (satae/api.py:33-35)
BEST_ALPHA = 35.0
BEST_AE_LR = 5e-3
BEST_MLP_LR = 1e-4


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` if a card is present, else raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: satae_torch serves on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class FitSummary:
    ae_val_loss: Optional[float]  # None for reuse_ae fits (no AE training)
    ae_hparams: Dict[str, float]
    mlp_val_acc: float
    mlp_hparams: Dict[str, float]
    test_acc: Optional[float] = None
    # wall-clock seconds per stage: data / ae / extract / mlp / eval
    stage_seconds: Optional[Dict[str, float]] = None


class SatAEPipeline:
    """Autoencoder + MLP, fitted or loaded, run on ``device`` through the
    kernels."""

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
        # per-epoch train/val curves of the last fit, {"ae": ..., "mlp": ...}
        # (None for a reused AE): satae draws them into out_dir instead
        self.history: Optional[Dict[str, Optional[Dict[str, List[float]]]]] \
            = None

    # -- training ----------------------------------------------------------

    def fit(self, raw: Optional[RawDataset] = None, *, grid: bool = False,
            log: Optional[LogFn] = None, out_dir: Optional[str] = None,
            reuse_ae: bool = False) -> FitSummary:
        """Run the single-config pipeline on ``raw`` (default: the dataset
        ``config.data`` names): AE training (alpha 35, lr 5e-3), latent
        extraction, MLP training (lr 1e-4) and the test-split score, which
        is the accuracy :meth:`predict` gives on the test split.

        ``reuse_ae=True`` skips AE training and extracts through the loaded
        autoencoder (:meth:`load` or :meth:`load_torch` first). The grid
        sweeps (``grid=True``) and run-directory output (``out_dir``) are
        not ported yet."""
        if grid or out_dir is not None:
            raise NotImplementedError(
                "satae_torch fits the single reference-optimal config only: "
                "the grid sweeps and out_dir checkpoints are a later slice "
                "(ROADMAP.md §1 item 9)")
        if reuse_ae and self.ae is None:
            raise ValueError("reuse_ae=True requires a loaded autoencoder - "
                             "call load() or load_torch() first")
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return self._fit(raw, log, reuse_ae)

    def _fit(self, raw: Optional[RawDataset], log: Optional[LogFn],
             reuse_ae: bool) -> FitSummary:
        cfg, dev = self.config, self.device
        bs = cfg.data.batch_size
        stage_t: Dict[str, float] = {}
        t_mark = time.perf_counter()

        def stage(name: str) -> None:
            # every stage ends in a host read (epoch sums, latents,
            # predictions), so no device work leaks across a mark
            nonlocal t_mark
            now = time.perf_counter()
            stage_t[name] = round(now - t_mark, 2)
            t_mark = now

        splits = make_splits(raw or load_dataset(cfg.data), cfg.data)
        self.classes = splits.classes
        stage("data")

        ae_res = None
        if reuse_ae:
            ae_hp = {"reused": True}
        else:
            ae_res = train_supervised_ae(
                splits.train, splits.val, model_cfg=cfg.model,
                data_cfg=cfg.data, alpha=BEST_ALPHA, lr=BEST_AE_LR,
                device=dev, max_epochs=cfg.ae.max_epochs,
                patience=cfg.ae.patience, seed=cfg.runtime.seed, log=log)
            ae_hp = {"alpha": BEST_ALPHA, "lr": BEST_AE_LR}
            ae = SupervisedAE(cfg.model, cfg.data.channels,
                              cfg.data.image_size).to(dev)
            ae.load_state_dict(ae_res.state_dict())
            self.ae = ae.eval()
        stage("ae")

        Xtr, ytr = extract_features(self.ae.enc, splits.train, bs)
        Xva, yva = extract_features(self.ae.enc, splits.val, bs)
        Xte, yte = extract_features(self.ae.enc, splits.test, bs)
        stage("extract")

        mlp_res = train_mlp(
            Xtr, ytr, Xva, yva, model_cfg=cfg.model, lr=BEST_MLP_LR,
            device=dev, weight_decay=cfg.mlp.weight_decay,
            epochs=cfg.mlp.epochs, batch_size=bs, seed=cfg.runtime.seed,
            log=log)
        mlp = MLP(cfg.model, input_dim=Xtr.shape[-1]).to(dev)
        mlp.load_state_dict(mlp_res.state_dict())
        self.mlp = mlp.eval()
        self.history = {"ae": None if ae_res is None else ae_res.history,
                        "mlp": mlp_res.history}
        stage("mlp")

        # the test split's already-extracted latents through the served
        # (folded) MLP: test_acc is what predict() scores
        _, fm = self._folded_weights()
        with torch.no_grad():
            logits = fast_infer.mlp_infer(fm, torch.from_numpy(Xte).to(dev))
        test_preds = torch.argmax(logits, dim=-1).cpu().numpy()
        test_acc = float((test_preds == yte).mean())
        stage("eval")
        return FitSummary(
            None if ae_res is None else ae_res.best_val_loss, ae_hp,
            mlp_res.best_val_acc, {"lr": BEST_MLP_LR}, test_acc,
            stage_seconds=dict(stage_t))

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
            raise RuntimeError("pipeline is not loaded — call fit(), load() "
                               "or load_torch()")
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


# -- module-level conveniences ---------------------------------------------

def fit(config: Optional[PipelineConfig] = None, device=None,
        **kwargs) -> SatAEPipeline:
    """A new pipeline on ``device``, fitted (see :meth:`SatAEPipeline.fit`
    for ``kwargs``)."""
    pipe = SatAEPipeline(config, device)
    pipe.fit(**kwargs)
    return pipe
