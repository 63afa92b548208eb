"""Public API: the counterpart of satae/api.py.

``SatAEPipeline.fit`` runs satae's pipeline (api.py:119-336). With
``grid=True`` that is the alpha x lr supervised-AE sweep with early stopping
(45 configs by default), frozen-encoder latent extraction, the lr sweep of
the MLP (11 lrs) with each lr's test accuracy, and the test-split score;
with ``grid=False`` the single reference-optimal config (AE alpha 35, lr
5e-3; MLP lr 1e-4). ``out_dir`` makes it a run directory in satae's format:
the sweeps' resumable stores (``validation_losses.json``,
``mlp_results.json``), the global-best ``.msgpack`` checkpoints with their
selection meta, ``fit_summary.json``, ``classes.json`` and the encoder
fingerprint that guards the MLP store (``mlp_provenance.json``). A run
directory written by either package is loaded and resumed by the other.
Training computes in ``RuntimeConfig.compute_dtype``, float32 or satae's
bf16 recipe (bf16 compute, float32 master parameters, BatchNorm stats,
Adam moments and selection metrics; the MLP in float32; with
``config.throughput_config`` its batch 1024), with TF32 off and only
deterministic algorithms for cuDNN, so a fit repeats bit for bit on the
card as it does on the CPU and as satae's does (a training run is chaotic:
one nondeterministic convolution gradient moves its outcome). On a CUDA
device every linear layer's forward and backward runs on kernel K1 (its
bf16 instantiation for the autoencoder's in bf16), and extraction runs on
K2 + K1; the convolutions, transposed convolutions, BatchNorm, losses and
Adam are stock PyTorch ops, as they are XLA ops in satae.

``SatAEPipeline`` also loads a fitted pipeline (:meth:`load`,
:meth:`load_ae`, or the reference notebook's ``.pt`` state_dicts with
:meth:`load_torch`), saves it (:meth:`save`, :meth:`export_torch`),
evaluates a split (:meth:`evaluate`) and serves ``encode``, ``predict``,
``predict_proba``, ``decode`` and ``reconstruct`` through the fixed-chunk
bulk path of satae (api.py:527-655): chunks of 64 images (or latents) for
inputs of up to 64, of 512 otherwise, padding rows sliced off. On a card,
page-locked images of several chunks are uploaded in slices of whole chunks
on a copy stream, each chunk computing while the next slice uploads
(:func:`upload_slices`).
On a CUDA device every chunk runs satae_torch.models.fast_infer on the
hand-written kernels (K2 per conv layer, K1 per linear layer; the encoder in
the compute dtype, its weights cast once, the MLP on float32 latents, as
satae's api.py:399-415); the decoder's input linear is one K1 launch and its
transposed convolutions are ``F.conv_transpose2d``, as they are XLA ops in
satae. With ``device="cpu"`` the same code runs the kernels' plain PyTorch
versions.

``ae.checkpoint_every`` with ``out_dir`` flushes the autoencoder's in-flight
train state under ``out_dir/inflight/`` every N epochs, in satae's files, so
a killed fit resumes mid-training (satae_torch.train.fast_loop). With
``out_dir`` the fit also draws satae's ``ae_best_curves.png`` and
``mlp_best_curves.png``; where matplotlib is not installed it logs which
figure it did not write and goes on (figures the caller asks for, as
``runtime.save_grid_curves``, raise ``ImportError`` there).
``runtime.debug_nans`` raises ``FloatingPointError`` at the first
non-finite loss or gradient of a train step (satae_torch.utils.profiling).

The device is explicit. ``device=None`` means the first CUDA device, and
raises where there is none: the pipeline never drops to the CPU by itself.

``runtime.parallel_configs`` with ``grid=True`` trains each sweep's configs
at once, satae's vmap engine (satae_torch.train.vmap_sweep: stacked models,
the batched K1 for every linear layer on the card).

``SatAEPipeline(config, encoder=ViTConfig(...))`` serves a ViT encoder in
place of the autoencoder's (satae_torch.models.vit: MAE's encoder, as
Prithvi-EO-1.0-100M has it, loaded with :meth:`load_torch` from its
``state_dict``) and the MLP of ``config.model`` on its latents
(``latent_dim`` = the ViT's ``embed_dim``). Its input is int16 reflectance
chips (N, bands, frames, H, W), uploaded as int16 and normalised per band
on the card; ``encode``, ``predict`` and ``predict_proba`` (and their
``_batched`` forms) serve it through the same chunks and upload, each chunk
on ``fast_infer.vit_encoder_infer`` (K1 for every Linear, the attention
and LayerNorm kernels, bf16 on the card). ``encoder=SwinConfig(...)``
serves a Swin Transformer V2 encoder the same way (satae_torch.models.swin:
torchvision's ``swin_v2_b`` features, as SatlasPretrain ships them for
Sentinel-2, loaded under torchvision's keys, a wrapper's ``backbone.``
prefix stripped): int16 chips (N, bands, H, W), each chunk on
``fast_infer.swin_encoder_infer`` (K1, the window-attention kernel and the
LayerNorm kernel in both modes), the MLP on its ``latent_dim`` = 8 x
``embed_dim``. Training either (MAE or Satlas pretraining), decoding and
the run-directory formats are the autoencoder's alone: those methods
raise.

``runtime.n_devices = N`` runs satae's multi-device paths over a world of
N ranks, one process and one device each (satae_torch.parallel: a process
group of N ranks, from ``torchrun`` with ``runtime.multihost``; one rank
makes its own). ``fit`` then trains the single config data-parallel with
global-batch BatchNorm, or (``grid=True``) runs the config-sharded sweeps,
``runtime.grid_dp`` ranks per config on a config x data mesh; extraction
and serving shard each chunk over the ranks and all-gather. Every rank
runs the same call with the same arguments and gets the same result; the
run directory's files are written by every rank with the same bytes, the
figures by the primary rank only. satae runs such paths from one process
over all its devices; ``n_devices = 2`` in one plain process raises
``ValueError`` here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from satae_torch.config import (PipelineConfig, SwinConfig, ViTConfig,
                                default_config)
from satae_torch.data.ingest import RawDataset, load_dataset
from satae_torch.data.pipeline import ArrayDataset, make_splits
from satae_torch.eval import metrics as M
from satae_torch.io import checkpoint, convert
from satae_torch.models import fast_infer
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.models.swin import SwinEncoder, swin_state_dict
from satae_torch.models.vit import ViTEncoder, encoder_state_dict
from satae_torch.nn.layers import float32_convs
from satae_torch.parallel import make_grid_mesh, make_mesh
from satae_torch.parallel.distributed import (check_world, is_primary,
                                              local_device, maybe_initialize)
from satae_torch.parallel.dp import make_dp_decode_step
from satae_torch.train.extract import extract_features, make_decode_step
from satae_torch.train.fast_loop import train_mlp, train_supervised_ae
from satae_torch.train.gridsearch import ae_grid_search, mlp_grid_search
from satae_torch.train.loop import LogFn
from satae_torch.train.shard_sweep import (ae_sharded_grid_search,
                                           mlp_sharded_grid_search)
from satae_torch.train.vmap_sweep import (ae_vmap_grid_search,
                                          mlp_vmap_grid_search)
from satae_torch.train.sweep_common import save_best_checkpoint
from satae_torch.utils.profiling import debug_mode, span
from satae_torch.utils.strict_json import dump_strict_json

# Reference-optimal single-config hyperparameters (satae/api.py:33-35)
BEST_ALPHA = 35.0
BEST_AE_LR = 5e-3
BEST_MLP_LR = 1e-4


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` if a card is present, else raise. Within a
    process group a CUDA device without an index is this rank's,
    ``cuda:LOCAL_RANK`` (satae_torch.parallel.distributed.local_device)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: satae_torch serves on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        device = "cuda"
    return local_device(device)


# the frozen encoder families: config -> (module, the checkpoint's keys it
# loads, fold)
FROZEN = {ViTConfig: (ViTEncoder, encoder_state_dict, fast_infer.fold_vit),
          SwinConfig: (SwinEncoder, swin_state_dict, fast_infer.fold_swin)}
FrozenConfig = Union[ViTConfig, SwinConfig]


def _family(cfg) -> str:
    """The encoder family's name: "ViT", "Swin"."""
    return type(cfg).__name__[:-len("Config")]


def serve_chunk(n: int, batch_size: int, n_devices: int = 1) -> int:
    """The fixed serving chunk for ``n`` inputs, as satae's
    ``_serve_chunk``: one training batch rounded up to a multiple of the
    devices while ``n`` fits in it, else eight batches rounded up the same
    way (64 / 512 at the default config on one device)."""
    small = -(-batch_size // n_devices) * n_devices
    if n <= small:
        return small
    return -(-batch_size * 8 // n_devices) * n_devices


# Most host-to-device copies one serving call issues on its copy stream
UPLOAD_SLICES = 8


def upload_slices(n: int, chunk: int,
                  overlap: bool) -> List[Tuple[int, int]]:
    """The row ranges [lo, hi) of the padded serving buffer (``n`` rows
    padded to whole ``chunk``-row chunks) that ``_serve_batched`` uploads
    one copy each, every range a run of whole chunks. ``overlap``: whether a
    copy can run under the card's compute, which takes a CUDA device and
    page-locked host rows (from pageable memory the driver stages each copy
    through the host and it ran under no kernel). One range, the whole
    buffer, without it or when the rows fit in one chunk; else the chunks
    split evenly into at most ``UPLOAD_SLICES`` ranges: one chunk a range
    for a few large chunks, several for many small ones, so the copies a
    call issues stay few where its host already launches a kernel every
    few microseconds."""
    total = n + (-n) % chunk
    chunks = total // chunk
    if not overlap or chunks == 1:
        return [(0, total)]
    step = -(-chunks // UPLOAD_SLICES) * chunk
    return [(lo, min(lo + step, total)) for lo in range(0, total, step)]


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
    kernels; with ``encoder`` a ViT or Swin encoder (loaded, frozen) +
    MLP."""

    def __init__(self, config: Optional[PipelineConfig] = None, device=None,
                 encoder: Optional[FrozenConfig] = None):
        self.config = config or default_config()
        rt = self.config.runtime
        self.encoder_config = encoder
        if encoder is not None:
            if type(encoder) not in FROZEN:
                raise TypeError(f"encoder must be one of "
                                f"{[t.__name__ for t in FROZEN]}, got "
                                f"{type(encoder).__name__}")
            if self.config.model.latent_dim != encoder.latent_dim:
                raise ValueError(
                    f"the MLP on the {_family(encoder)} encoder's "
                    f"latents needs model.latent_dim = its latent width "
                    f"({encoder.latent_dim}), got "
                    f"{self.config.model.latent_dim}")
            if rt.n_devices:
                raise ValueError("a frozen encoder is served on one device "
                                 "(runtime.n_devices unset)")
        # the process group first (a no-op unless asked for), then this
        # rank's device; the mesh's shape is checked before any work
        maybe_initialize(rt.multihost, resolve_device(device))
        self.device = resolve_device(device)
        if rt.n_devices:
            check_world(rt.n_devices)
            if rt.n_devices % rt.grid_dp:
                raise ValueError(f"n_devices ({rt.n_devices}) must be "
                                 f"divisible by grid_dp ({rt.grid_dp})")
        self._meshes: Dict[str, Any] = {}
        self.ae: Optional[SupervisedAE] = None
        self.frozen: Optional[torch.nn.Module] = None  # a FROZEN encoder
        self.mlp: Optional[MLP] = None
        self.classes = None
        # the run directory the autoencoder was loaded from (resolved), so
        # fit and save into that directory keep its selection meta
        self._ae_src_dir: Optional[str] = None
        self._folded = None
        self._folded_src = None
        self._copier: Optional[torch.cuda.Stream] = None
        # per-epoch train/val curves of the last fit, {"ae": ..., "mlp": ...}
        # (None for a reused AE): satae draws them into out_dir instead
        self.history: Optional[Dict[str, Optional[Dict[str, List[float]]]]] \
            = None

    # -- meshes --------------------------------------------------------------

    def _mesh(self, grid: bool = False):
        """None without ``runtime.n_devices``; else the 1-D data mesh over
        its ranks, or for the sweeps (``grid``) the config x data mesh of
        ``runtime.grid_dp`` ranks per config (satae's ``_grid_mesh``), each
        built once."""
        rt = self.config.runtime
        if not rt.n_devices:
            return None
        key = "grid" if grid and rt.grid_dp > 1 else "data"
        if key not in self._meshes:
            self._meshes[key] = (
                make_grid_mesh(rt.n_devices // rt.grid_dp, rt.grid_dp,
                               data_axis=rt.mesh_axis, device=self.device)
                if key == "grid" else
                make_mesh(rt.n_devices, rt.mesh_axis, self.device))
        return self._meshes[key]

    # -- training ----------------------------------------------------------

    def fit(self, raw: Optional[RawDataset] = None, *, grid: bool = False,
            log: Optional[LogFn] = None, out_dir: Optional[str] = None,
            reuse_ae: bool = False) -> FitSummary:
        """Run the pipeline on ``raw`` (default: the dataset ``config.data``
        names). ``grid=True`` runs the alpha x lr AE sweep of ``config.ae``
        and the lr sweep of ``config.mlp``; ``grid=False`` the
        reference-optimal config only (alpha 35, lr 5e-3; MLP lr 1e-4). The
        test-split score is the accuracy :meth:`predict` gives there.

        ``reuse_ae=True`` skips AE training and extracts through the loaded
        autoencoder (:meth:`load`, :meth:`load_ae` or :meth:`load_torch`
        first).

        ``out_dir`` identifies one experiment, as in satae: the sweep stores
        resume by hyperparameter key and assume the dataset and seed are
        unchanged across runs that share it. The encoder -> MLP pairing is
        fingerprint-guarded (``mlp_provenance.json``); a changed dataset or
        seed is not.

        With ``config.ae.checkpoint_every`` and ``out_dir`` the AE training
        flushes its in-flight state every N epochs (``inflight/``) and a
        rerun resumes from it; the files are removed once the winner is
        recorded."""
        self._require_ae("fit")
        cfg = self.config
        if reuse_ae and self.ae is None:
            raise ValueError("reuse_ae=True requires a loaded autoencoder - "
                             "call load(), load_ae() or load_torch() first")
        with float32_convs(deterministic=True), \
                debug_mode(cfg.runtime.debug_nans):
            return self._fit(raw, grid, log, out_dir, reuse_ae)

    def _fit(self, raw: Optional[RawDataset], grid: bool,
             log: Optional[LogFn], out_dir: Optional[str],
             reuse_ae: bool) -> FitSummary:
        cfg, dev = self.config, self.device
        bs, seed = cfg.data.batch_size, cfg.runtime.seed
        dtype = cfg.compute_dtype
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
        # the single config's in-flight state, removed only once its winner
        # is written (in _write_run_dir): a kill during extraction or the MLP
        # must not lose the AE training
        inflight = None
        curves = cfg.runtime.save_grid_curves
        if reuse_ae:
            ae_hp = {"reused": True}
        elif grid:
            kw = dict(model_cfg=cfg.model, data_cfg=cfg.data, ae_cfg=cfg.ae,
                      device=dev, seed=seed, out_dir=out_dir, log=log,
                      compute_dtype=dtype, save_curves=curves)
            if cfg.runtime.n_devices:
                sweep = ae_sharded_grid_search(
                    splits.train, splits.val, mesh=self._mesh(grid=True),
                    **kw)
            else:
                search = ae_vmap_grid_search \
                    if cfg.runtime.parallel_configs else ae_grid_search
                sweep = search(splits.train, splits.val, **kw)
            ae_res, ae_hp = sweep.best, sweep.best_hparams
        else:
            if out_dir and cfg.ae.checkpoint_every:
                inflight = Path(out_dir) / "inflight" / "ae_single.msgpack"
            ae_res = train_supervised_ae(
                splits.train, splits.val, model_cfg=cfg.model,
                data_cfg=cfg.data, alpha=BEST_ALPHA, lr=BEST_AE_LR,
                device=dev, max_epochs=cfg.ae.max_epochs,
                patience=cfg.ae.patience, seed=seed, log=log,
                compute_dtype=dtype,
                checkpoint_path=None if inflight is None else str(inflight),
                checkpoint_every=cfg.ae.checkpoint_every, mesh=self._mesh())
            ae_hp = {"alpha": BEST_ALPHA, "lr": BEST_AE_LR}
        if ae_res is not None:
            ae = SupervisedAE(cfg.model, cfg.data.channels,
                              cfg.data.image_size).to(dev)
            ae.load_state_dict(ae_res.state_dict())
            self.ae = ae.eval()
            self._ae_src_dir = None  # freshly trained or a sweep's winner
        stage("ae")

        mesh = self._mesh()
        Xtr, ytr = extract_features(self.ae.enc, splits.train, bs, dtype, mesh)
        Xva, yva = extract_features(self.ae.enc, splits.val, bs, dtype, mesh)
        Xte, yte = extract_features(self.ae.enc, splits.test, bs, dtype, mesh)
        stage("extract")

        if out_dir:
            self._guard_mlp_store(out_dir)
        if grid:
            kw = dict(model_cfg=cfg.model, mlp_cfg=cfg.mlp, device=dev,
                      batch_size=bs, seed=seed, out_dir=out_dir, log=log,
                      test_x=Xte, test_y=yte, save_curves=curves)
            if cfg.runtime.n_devices:
                msweep = mlp_sharded_grid_search(
                    Xtr, ytr, Xva, yva, mesh=self._mesh(grid=True), **kw)
            else:
                search = mlp_vmap_grid_search \
                    if cfg.runtime.parallel_configs else mlp_grid_search
                msweep = search(Xtr, ytr, Xva, yva, **kw)
            mlp_res, mlp_hp = msweep.best, msweep.best_hparams
        else:
            mlp_res = train_mlp(
                Xtr, ytr, Xva, yva, model_cfg=cfg.model, lr=BEST_MLP_LR,
                device=dev, weight_decay=cfg.mlp.weight_decay,
                epochs=cfg.mlp.epochs, batch_size=bs, seed=seed, log=log)
            mlp_hp = {"lr": BEST_MLP_LR}
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
        summary = FitSummary(
            None if ae_res is None else ae_res.best_val_loss, ae_hp,
            mlp_res.best_val_acc, mlp_hp, test_acc,
            stage_seconds=dict(stage_t))
        if out_dir:
            self._write_run_dir(Path(out_dir), summary, grid, reuse_ae,
                                ae_res, mlp_res, inflight, log)
        return summary

    def _write_run_dir(self, out: Path, summary: FitSummary, grid: bool,
                       reuse_ae: bool, ae_res, mlp_res,
                       inflight: Optional[Path],
                       log: Optional[LogFn]) -> None:
        """What satae's fit writes into ``out_dir`` (api.py:284-335)."""
        if not grid:
            # the sweeps checkpointed their winners with the full selection
            # meta (the 'diverged' marker included); only the single-config
            # trainers write nothing themselves
            if ae_res is not None:
                save_best_checkpoint(out, "ae_global_best", *self._ae_trees(),
                                     summary.ae_hparams, ae_res)
            save_best_checkpoint(out, "mlp_global_best", *self._mlp_trees(),
                                 summary.mlp_hparams, mlp_res)
            if inflight is not None:
                checkpoint.clear_train_state(inflight)
        if reuse_ae and self._ae_src_dir != str(out.resolve()):
            # an encoder from elsewhere makes out_dir a complete run
            # directory, overwriting a stale AE; the same-directory flow
            # keeps the file, whose meta the sweep's resume protection reads
            checkpoint.save_model(out / "ae_global_best.msgpack",
                                  *self._ae_trees(),
                                  meta=dict(summary.ae_hparams))
        checkpoint.write_text_atomic(
            out / "fit_summary.json",
            dump_strict_json(dataclasses.asdict(summary), indent=2))
        if self.classes:
            checkpoint.write_text_atomic(out / "classes.json",
                                         json.dumps(list(self.classes)))
        figures = []
        if ae_res is not None and ae_res.history:
            figures.append(("loss_curves", ae_res.history, "ae_best_curves",
                            f"Best AE ({summary.ae_hparams})"))
        if mlp_res.history:
            figures.append(("accuracy_curves", mlp_res.history,
                            "mlp_best_curves",
                            f"Best MLP ({summary.mlp_hparams})"))
        if not figures or not is_primary():
            return
        try:
            from satae_torch.eval import plots
        except ImportError:
            # satae draws these unasked; without matplotlib the run directory
            # is complete all the same
            for _, _, name, _ in figures:
                msg = f"matplotlib is not installed: {name}.png not written"
                if log:
                    log(msg)
                else:
                    warnings.warn(msg)
            return
        for fn, history, name, title in figures:
            getattr(plots, fn)(history, out / f"{name}.png", title=title)

    def _guard_mlp_store(self, out_dir: str) -> None:
        """Invalidate MLP artifacts trained on another encoder's latents
        (satae/api.py:338-370). ``mlp_results.json`` and the
        ``mlp_global_best`` resume competition assume the latents, hence the
        encoder, are unchanged across runs sharing ``out_dir``. Each fit
        stamps ``mlp_provenance.json`` with the sha1 of the encoder's
        checkpoint bytes (satae's: the writer gives flax's bytes); a
        mismatch clears the store and the global-best pair."""
        ae_p, ae_s = self._ae_trees()
        fp = hashlib.sha1(checkpoint.packb(
            {"p": ae_p["encoder"], "s": ae_s["encoder"]})).hexdigest()
        out = Path(out_dir)
        prov = out / "mlp_provenance.json"
        old = None
        if prov.exists():
            try:
                old = json.loads(prov.read_text()).get("ae_fingerprint")
            except (json.JSONDecodeError, OSError, AttributeError):
                old = None
        if old is not None and old != fp:
            for name in ("mlp_results.json", "mlp_global_best.msgpack",
                         "mlp_global_best.json"):
                (out / name).unlink(missing_ok=True)
        out.mkdir(parents=True, exist_ok=True)
        checkpoint.write_text_atomic(prov, json.dumps({"ae_fingerprint": fp}))
        mesh = self._mesh()
        if mesh is not None:
            # every rank has cleared a stale store before any rank's sweep
            # reads it
            mesh.all_reduce_(torch.zeros(1, device=self.device))

    # -- satae's trees -----------------------------------------------------

    def _ae_trees(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        d = self.config.data
        return convert.sae_from_torch_state_dict(
            self.ae.state_dict(), self.config.model, d.channels, d.image_size)

    def _mlp_trees(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return convert.mlp_from_torch_state_dict(self.mlp.state_dict(),
                                                 self.config.model)

    # -- loading and saving ------------------------------------------------

    def _install_ae(self, sd) -> None:
        d = self.config.data
        ae = SupervisedAE(self.config.model, d.channels, d.image_size)
        ae.load_state_dict(sd, strict=True)
        self.ae = ae.to(self.device).eval()

    def _install_mlp(self, sd) -> None:
        mlp = MLP(self.config.model)
        mlp.load_state_dict(sd, strict=True)
        self.mlp = mlp.to(self.device).eval()

    def load_ae(self, out_dir: str) -> "SatAEPipeline":
        """Load only the autoencoder of a run directory, for
        ``fit(reuse_ae=True)`` (the reference's phase-2 restart)."""
        self._require_ae("load_ae")
        ae_file = Path(out_dir) / "ae_global_best.msgpack"
        if not ae_file.exists():
            raise FileNotFoundError(f"no AE checkpoint at {ae_file}")
        cfg = self.config
        self._install_ae(convert.to_tensors(convert.sae_to_torch_state_dict(
            *checkpoint.load_model(ae_file), cfg.model, cfg.data.image_size)))
        self._ae_src_dir = str(Path(out_dir).resolve())
        classes_file = Path(out_dir) / "classes.json"
        if classes_file.exists():
            self.classes = tuple(json.loads(classes_file.read_text()))
        return self

    def load(self, out_dir: str) -> "SatAEPipeline":
        """Load a run directory of either package (``ae_global_best.msgpack``
        + ``mlp_global_best.msgpack``, optional ``classes.json``)."""
        ae_file = Path(out_dir) / "ae_global_best.msgpack"
        mlp_file = Path(out_dir) / "mlp_global_best.msgpack"
        self._require_ae("load")
        missing = [str(p) for p in (ae_file, mlp_file) if not p.exists()]
        if missing:
            raise FileNotFoundError(
                f"no fitted pipeline under {out_dir!r} (missing: "
                f"{', '.join(missing)})")
        self.load_ae(out_dir)
        self._install_mlp(convert.to_tensors(convert.mlp_to_torch_state_dict(
            *checkpoint.load_model(mlp_file), self.config.model)))
        return self

    def load_torch(self, ae_pt, mlp_pt=None) -> "SatAEPipeline":
        """Load the reference notebook's ``AE_GLOBAL_BEST.pt`` (and
        ``MLP_GLOBAL_BEST.pt``) state_dicts, strictly. Without ``mlp_pt``
        only the autoencoder is replaced: a loaded MLP stays, as in satae
        (api.py:758-778); pair it with ``fit(reuse_ae=True)`` to train the
        MLP on the notebook's encoder. Each argument is a file or the
        state_dict itself.

        With a ViT ``encoder``, ``ae_pt`` is its ``state_dict`` under the
        source's keys (``patch_embed.proj.weight``, ``blocks.{i}.attn.qkv``,
        ...); a full MAE checkpoint's decoder and mask token are left out,
        every other key must match. With a Swin ``encoder``, torchvision's
        ``features.*`` keys, buffers included, under a wrapper's
        ``backbone.backbone.`` or ``backbone.`` prefix or none; the final
        ``norm``, the ``head`` and a wrapper's other keys are left out."""
        load = lambda p: p if isinstance(p, dict) else \
            torch.load(p, map_location="cpu", weights_only=True)
        if self.encoder_config is not None:
            module, keys, _ = FROZEN[type(self.encoder_config)]
            enc = module(self.encoder_config)
            enc.load_state_dict(keys(load(ae_pt)), strict=True)
            self.frozen = enc.to(self.device).eval()
        else:
            self._install_ae(load(ae_pt))
        self._ae_src_dir = None  # a foreign checkpoint, no run directory
        if mlp_pt is not None:
            self._install_mlp(load(mlp_pt))
        return self

    def save(self, out_dir: str) -> None:
        """Write the loaded models as satae's ``.msgpack`` checkpoints (an
        AE-only pipeline writes the autoencoder alone; reload it with
        :meth:`load_ae`). Saving weights that did not come from this
        directory also removes its ``*_global_best.json`` sidecars: they
        describe the previous weights' sweep metrics, and would mislabel
        the new checkpoints and compete in a later sweep's resume."""
        self._require_ae("save")
        self._require_fitted()
        out = Path(out_dir)
        same_src = self._ae_src_dir == str(out.resolve())
        checkpoint.save_model(out / "ae_global_best.msgpack",
                              *self._ae_trees())
        if not same_src:
            (out / "ae_global_best.json").unlink(missing_ok=True)
        if self.mlp is not None:
            checkpoint.save_model(out / "mlp_global_best.msgpack",
                                  *self._mlp_trees())
            if not same_src:
                (out / "mlp_global_best.json").unlink(missing_ok=True)
        if self.classes:
            checkpoint.write_text_atomic(out / "classes.json",
                                         json.dumps(list(self.classes)))

    def export_torch(self, dest_dir: str) -> None:
        """Write the models as the reference notebook's ``.pt`` state_dicts,
        ``AE_GLOBAL_BEST.pt`` (+ ``MLP_GLOBAL_BEST.pt``): the dicts satae's
        ``export_torch`` writes, the same keys and values, on the CPU,
        ``num_batches_tracked`` 0."""
        self._require_ae("export_torch")
        self._require_fitted()
        dest = Path(dest_dir)
        dest.mkdir(parents=True, exist_ok=True)
        cfg = self.config
        torch.save(convert.to_tensors(convert.sae_to_torch_state_dict(
            *self._ae_trees(), cfg.model, cfg.data.image_size)),
            dest / "AE_GLOBAL_BEST.pt")
        if self.mlp is not None:
            torch.save(convert.to_tensors(convert.mlp_to_torch_state_dict(
                *self._mlp_trees(), cfg.model)), dest / "MLP_GLOBAL_BEST.pt")

    def evaluate(self, ds: ArrayDataset) -> Dict[str, Any]:
        """Confusion matrix, per-class metrics and the sklearn-layout report
        over a split (the reference's final evaluation), from
        :meth:`predict`."""
        preds = self.predict_batched(ds.images)
        k = self.config.model.num_classes
        cm = M.confusion_matrix(ds.labels, preds, k)
        out = M.per_class_metrics(cm)
        out["confusion_matrix"] = cm
        out["report"] = M.classification_report(
            ds.labels, preds, k, target_names=self.classes, cm=cm)
        return out

    # -- inference ---------------------------------------------------------

    def _require_ae(self, what: str) -> None:
        if self.encoder_config is not None:
            raise NotImplementedError(
                f"{what}: the {_family(self.encoder_config)} encoder "
                "is served frozen from its loaded weights; its pretraining, "
                "decoder and the run-directory formats are not implemented "
                "(they are the autoencoder's)")

    def _encoder(self):
        return self.ae if self.encoder_config is None else self.frozen

    def _require_fitted(self, mlp: bool = False) -> None:
        if self._encoder() is None:
            raise RuntimeError("pipeline is not loaded — call fit(), load() "
                               "or load_torch()")
        if mlp and self.mlp is None:
            raise RuntimeError("no classifier: only the autoencoder is "
                               "loaded (load_ae, or load_torch without "
                               "mlp_pt)")

    def _folded_weights(self):
        """Folded, packed weights for the kernels (the encoder's for the
        compute dtype), computed once per weight set: refreshed when
        ``ae``/``mlp`` are reassigned or their tensors change in place
        (``load_state_dict`` bumps their versions)."""
        enc = self._encoder()
        versions = tuple((t.data_ptr(), t._version)
                         for m in (enc, self.mlp) if m is not None
                         for t in m.state_dict().values())
        src = self._folded_src
        if src is None or src[0] is not enc or src[1] is not self.mlp \
                or src[2] != versions:
            dtype = self.config.compute_dtype
            cfg = self.encoder_config
            self._folded = (
                fast_infer.fold_encoder(enc.enc, dtype) if cfg is None else
                FROZEN[type(cfg)][2](enc, cfg, dtype),
                None if self.mlp is None else fast_infer.fold_mlp(self.mlp))
            self._folded_src = (enc, self.mlp, versions)
        return self._folded

    def _serve_chunk(self, n: int) -> int:
        return serve_chunk(n, self.config.data.batch_size,
                           self.config.runtime.n_devices or 1)

    @torch.no_grad()
    def _serve_batched(self, images: np.ndarray, fe,
                       head: Callable[[torch.Tensor], torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The input padded on the device to whole fixed-size chunks, each
        encoded in the compute dtype, its latents chained into ``head`` on
        the device as float32 (satae's api.py:569-570), through ``fe``, the
        folded encoder (:class:`fast_infer.FoldedEncoder` on uint8 images,
        :class:`fast_infer.FoldedViT` and :class:`fast_infer.FoldedSwin` on
        int16 chips, normalised on the card), which checks the input
        (``fe.host``). Returns per-chunk
        outputs covering n + pad rows (padding rows never mix with real
        ones: eval-mode BN uses running stats, every layer is per image).
        With ``runtime.n_devices`` each rank runs its rows of every chunk,
        head included, and the outputs are all-gathered.

        The upload follows :func:`upload_slices`. With one slice (pageable
        images among them) it is one copy on the current stream. With
        several, each slice is copied on a copy stream and the current
        stream waits for a slice's event just before its chunks: slice 0 is
        copied first, and each next slice's copy is issued after the
        previous slice's chunks are launched, so it runs under their
        kernels. The span ``satae.serve.upload`` holds the buffer and the
        first slice's copy; its ``overlapped_bytes`` count the later
        slices'."""
        imgs = fe.host(images)
        n = len(imgs)
        chunk = self._serve_chunk(n)
        pad = (-n) % chunk
        host = torch.from_numpy(np.ascontiguousarray(imgs))
        card = self.device.type == "cuda"
        slices = upload_slices(n, chunk, card and host.is_pinned())
        side = len(slices) > 1 and card
        later = sum(min(hi, n) - lo for lo, hi in slices[1:])
        compute = torch.cuda.current_stream(self.device) if side else None

        def put(lo: int, hi: int) -> Optional[torch.cuda.Event]:
            """Issue the copy of rows [lo, min(hi, n)); the event that ends
            it on the copy stream, or None on the current stream."""
            hi = min(hi, n)
            if not side:
                dev[lo:hi].copy_(host[lo:hi])
                return None
            with torch.cuda.stream(self._copier):
                dev[lo:hi].copy_(host[lo:hi], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
            return ev

        with span("satae.serve.upload", bytes=imgs.nbytes,
                  overlapped_bytes=later * (imgs.nbytes // n)):
            dev = torch.empty((n + pad,) + imgs.shape[1:],
                              dtype=host.dtype, device=self.device)
            if pad:
                dev[n:].zero_()
            if side:
                if self._copier is None:
                    self._copier = torch.cuda.Stream(self.device)
                # the buffer's block may have served the current stream
                self._copier.wait_stream(compute)
            ready = put(*slices[0])
        out = []
        mesh = self._mesh()
        for i, (s_lo, s_hi) in enumerate(slices):
            if ready is not None:
                compute.wait_event(ready)
            for lo in range(s_lo, s_hi, chunk):
                part = dev[lo:lo + chunk]
                if mesh is not None:
                    part = mesh.shard(part)
                y = head(fe(part).float())
                out.append(y if mesh is None else mesh.gather_rows(y))
            if i + 1 < len(slices):
                ready = put(*slices[i + 1])
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
        with span("satae.serve"):
            self._require_fitted()
            n = len(np.asarray(images))
            if n == 0:
                return np.zeros((0, self.config.model.latent_dim),
                                np.float32)
            fe, _ = self._folded_weights()
            zs = self._serve_batched(images, fe, lambda z: z)
            return torch.cat(zs).cpu().numpy()[:n]

    def predict_batched(self, images: np.ndarray) -> np.ndarray:
        with span("satae.serve"):
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
        with span("satae.serve"):
            self._require_fitted(mlp=True)
            n = len(np.asarray(images))
            if n == 0:
                return np.zeros((0, self.config.model.num_classes),
                                np.float32)
            fe, fm = self._folded_weights()
            probs = self._serve_batched(
                images, fe,
                lambda z: torch.softmax(fast_infer.mlp_infer(fm, z), dim=-1))
            return torch.cat(probs).cpu().numpy()[:n]

    def _image_shape(self) -> Tuple[int, int, int]:
        d = self.config.data
        return d.image_size, d.image_size, d.channels

    @torch.no_grad()
    def decode(self, latents: np.ndarray) -> np.ndarray:
        """Latents (N, latent_dim) -> reconstructed images (N, H, W, C),
        float32 in [0, 1] (the decoder ends in a sigmoid): the inverse of
        :meth:`encode`. One upload, fixed chunks as :meth:`encode`; each
        chunk runs the eval-mode decoder in the compute dtype (its input
        linear one K1 launch on the card, its transposed convolutions
        cuDNN's with TF32 off)."""
        self._require_ae("decode")
        self._require_fitted()
        z = np.asarray(latents, np.float32)
        ld = self.config.model.latent_dim
        if z.ndim != 2 or z.shape[1] != ld:
            raise ValueError(f"latents must be (N, {ld}), got {z.shape}")
        n = len(z)
        if n == 0:
            return np.zeros((0,) + self._image_shape(), np.float32)
        chunk = self._serve_chunk(n)
        pad = (-n) % chunk
        dev = torch.zeros((n + pad, ld), device=self.device)
        dev[:n].copy_(torch.from_numpy(z))
        mesh = self._mesh()
        step = make_decode_step(self.ae.dec, self.config.compute_dtype) \
            if mesh is None else make_dp_decode_step(
                mesh, self.ae.dec, self.config.compute_dtype)
        with float32_convs(deterministic=True):
            outs = [step(dev[lo:lo + chunk])
                    for lo in range(0, n + pad, chunk)]
            return torch.cat(outs).cpu().numpy()[:n]

    def reconstruct(self, images: np.ndarray) -> np.ndarray:
        """Images -> the autoencoder's reconstructions ``x_hat``, float32 in
        [0, 1], through the fixed-chunk path (:meth:`reconstruct_batched`).
        An autoencoder alone (:meth:`load_ae`) serves it."""
        return self.reconstruct_batched(images)

    def reconstruct_batched(self, images: np.ndarray) -> np.ndarray:
        """Encoder and decoder in eval mode, chunk by chunk on the device:
        the folded encoder (K2 per conv layer and K1 for the projection on
        the card), its float32 latents into the decoder with no host round
        trip (TF32 off, as :meth:`decode`); the upload of
        :meth:`_serve_batched` and one readback."""
        self._require_ae("reconstruct")
        self._require_fitted()
        n = len(np.asarray(images))
        if n == 0:
            return np.zeros((0,) + self._image_shape(), np.float32)
        fe, _ = self._folded_weights()
        step = make_decode_step(self.ae.dec, self.config.compute_dtype)
        with float32_convs(deterministic=True):
            outs = self._serve_batched(images, fe, step)
            return torch.cat(outs).cpu().numpy()[:n]


# -- module-level conveniences ---------------------------------------------

def fit(config: Optional[PipelineConfig] = None, device=None,
        **kwargs) -> SatAEPipeline:
    """A new pipeline on ``device``, fitted (see :meth:`SatAEPipeline.fit`
    for ``kwargs``)."""
    pipe = SatAEPipeline(config, device)
    pipe.fit(**kwargs)
    return pipe


def encode(pipe: SatAEPipeline, images: np.ndarray) -> np.ndarray:
    return pipe.encode(images)


def predict(pipe: SatAEPipeline, images: np.ndarray) -> np.ndarray:
    return pipe.predict(images)
