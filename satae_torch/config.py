"""Typed configuration of the PyTorch port (counterpart of satae/config.py).

The five dataclasses keep the JAX package's fields and defaults, which are
the reference notebook's literals (see that module for the citations), with
one exception: ``RuntimeConfig.use_pallas`` is gone. It chose between the
Pallas kernels and XLA in satae; in the port the device chooses. On a CUDA
device the serving path always runs the hand-written kernels, and on the CPU
it runs their plain PyTorch versions (satae_torch.kernels).

``PipelineConfig.compute_dtype`` returns a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

EUROSAT_CLASSES: Tuple[str, ...] = (
    "AnnualCrop",
    "Forest",
    "HerbaceousVegetation",
    "Highway",
    "Industrial",
    "Pasture",
    "PermanentCrop",
    "Residential",
    "River",
    "SeaLake",
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Ingest / split / augmentation configuration."""

    root: Optional[str] = None  # EuroSAT class-folder tree; None -> synthetic
    image_size: int = 64
    channels: int = 3
    num_classes: int = 10
    per_class: int = 2000
    split_fractions: Tuple[float, float, float] = (0.70, 0.15, 0.15)
    split_seed: int = 42
    subsample_seed: int = 0
    batch_size: int = 64
    crop_padding: int = 4
    noise_std: float = 0.03
    cache_dir: Optional[str] = None
    synthetic_difficulty: str = "easy"  # "hard" = non-saturating tier
    aug_rng_impl: str = "threefry"

    def __post_init__(self):
        if abs(sum(self.split_fractions) - 1.0) > 1e-6:
            raise ValueError(
                f"split_fractions must sum to 1, got {self.split_fractions}")
        if self.per_class <= 0 or self.batch_size <= 0:
            raise ValueError("per_class and batch_size must be positive")
        if self.noise_std < 0 or self.crop_padding < 0:
            raise ValueError("noise_std and crop_padding must be >= 0")
        if self.aug_rng_impl not in ("threefry", "rbg"):
            raise ValueError(
                f"aug_rng_impl must be 'threefry' or 'rbg', "
                f"got {self.aug_rng_impl!r}")
        if self.synthetic_difficulty not in ("easy", "hard"):
            raise ValueError(
                f"synthetic_difficulty must be 'easy' or 'hard', "
                f"got {self.synthetic_difficulty!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture configuration."""

    latent_dim: int = 64
    encoder_channels: Tuple[int, ...] = (32, 64, 128, 256)
    head_hidden: int = 128
    mlp_hidden: Tuple[int, ...] = (128, 64)
    mlp_dropout: float = 0.3
    num_classes: int = 10
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class AETrainConfig:
    """Supervised-AE grid search configuration."""

    alphas: Tuple[float, ...] = (20.0, 25.0, 30.0, 35.0, 40.0)
    learning_rates: Tuple[float, ...] = (
        1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 1e-2, 5e-2, 1e-1,
    )
    max_epochs: int = 80
    patience: int = 15
    checkpoint_every: int = 0


@dataclasses.dataclass(frozen=True)
class MLPTrainConfig:
    """Latent MLP grid search configuration."""

    learning_rates: Tuple[float, ...] = (
        1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1,
    )
    epochs: int = 30
    weight_decay: float = 1e-4


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution configuration. No ``use_pallas``: see the module docstring."""

    seed: int = 0
    compute_dtype: str = "float32"
    mesh_axis: str = "data"
    n_devices: Optional[int] = None
    multihost: bool = False
    grid_dp: int = 1
    parallel_configs: bool = False
    debug_nans: bool = False
    save_grid_curves: bool = False

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(_DTYPES)}, got {self.compute_dtype!r}")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle mirroring the full notebook pipeline."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    ae: AETrainConfig = dataclasses.field(default_factory=AETrainConfig)
    mlp: MLPTrainConfig = dataclasses.field(default_factory=MLPTrainConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.runtime.compute_dtype]


def default_config() -> PipelineConfig:
    return PipelineConfig()


def throughput_config(cfg: PipelineConfig,
                      batch_size: int = 1024) -> PipelineConfig:
    """The large-batch sweep recipe: batch ``batch_size`` with every grid
    learning rate scaled by sqrt(batch_size / faithful batch), the Adam
    square-root rule. Selection, early stopping and checkpoints unchanged."""
    if batch_size % cfg.data.batch_size:
        raise ValueError(
            f"throughput batch_size {batch_size} must be a multiple of the "
            f"faithful batch_size {cfg.data.batch_size} (lr scaling rule)")
    k = math.sqrt(batch_size / cfg.data.batch_size)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, batch_size=batch_size),
        ae=dataclasses.replace(
            cfg.ae, learning_rates=tuple(lr * k
                                         for lr in cfg.ae.learning_rates)),
        mlp=dataclasses.replace(
            cfg.mlp, learning_rates=tuple(lr * k
                                          for lr in cfg.mlp.learning_rates)),
    )
