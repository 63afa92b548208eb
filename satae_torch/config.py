"""Typed configuration of the PyTorch port (counterpart of satae/config.py).

The five dataclasses keep the JAX package's fields and defaults, which are
the reference notebook's literals (see that module for the citations), with
one exception: ``RuntimeConfig.use_pallas`` is gone. It chose between the
Pallas kernels and XLA in satae; in the port the device chooses. On a CUDA
device the serving and training paths always run the hand-written kernels,
and on the CPU their plain PyTorch versions (satae_torch.kernels).

``PipelineConfig.compute_dtype`` returns a ``torch.dtype``.

:class:`ViTConfig` is the other encoder family the pipeline serves: a ViT
over multi-temporal, multispectral chips (MAE's encoder, as
Prithvi-EO-1.0-100M has it), handed to ``SatAEPipeline(..., encoder=)``;
``ModelConfig`` then gives the MLP on its latents (``latent_dim`` the
ViT's ``embed_dim``). :data:`PRITHVI_EO1_100M` holds that model's
published widths. :class:`SwinConfig` is the third: a Swin Transformer V2
over multispectral chips (torchvision's ``swin_v2_b``, as SatlasPretrain
ships it for Sentinel-2), its latent ``latent_dim`` = 8 x ``embed_dim``
wide; :data:`SATLAS_SWINV2B_S2MS` holds that model's published widths.
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
class ViTConfig:
    """A ViT encoder served frozen: chips (in_chans, num_frames, img_size,
    img_size) of int16 reflectance, normalised per band as (x - band_mean)
    / band_std, cut into tubelet_size x patch_size x patch_size patches, a
    class token prepended, ``depth`` pre-LayerNorm blocks (attention of
    ``num_heads``, an MLP of ``mlp_ratio`` x ``embed_dim`` with the exact
    GELU), a final LayerNorm; the latent is the mean of the patch tokens.
    The defaults are Prithvi-EO-1.0-100M's widths (its
    ``Prithvi_100M_config.yaml``); ``norm_eps`` is MAE's 1e-6 and the band
    constants are placeholders (0 and 1): set them to the checkpoint's."""

    img_size: int = 224
    patch_size: int = 16
    num_frames: int = 3
    tubelet_size: int = 1
    in_chans: int = 6
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6
    band_mean: Tuple[float, ...] = (0.0,) * 6
    band_std: Tuple[float, ...] = (1.0,) * 6

    def __post_init__(self):
        if self.img_size % self.patch_size \
                or self.num_frames % self.tubelet_size:
            raise ValueError("img_size and num_frames must be multiples of "
                             "patch_size and tubelet_size")
        if self.embed_dim % self.num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        if len(self.band_mean) != self.in_chans \
                or len(self.band_std) != self.in_chans:
            raise ValueError(f"band_mean and band_std need {self.in_chans} "
                             "values, one a band")

    @property
    def grid(self) -> Tuple[int, int, int]:
        """Patches along time, height and width."""
        side = self.img_size // self.patch_size
        return self.num_frames // self.tubelet_size, side, side

    @property
    def num_patches(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def latent_dim(self) -> int:
        return self.embed_dim

    @property
    def chip_shape(self) -> Tuple[int, int, int, int]:
        """One chip's (bands, frames, height, width)."""
        return (self.in_chans, self.num_frames, self.img_size, self.img_size)


PRITHVI_EO1_100M = ViTConfig()


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """A Swin Transformer V2 encoder served frozen: chips (in_chans,
    img_size, img_size) of int16 digital numbers, each band scaled by
    ``band_scale`` and clipped to [0, 1], cut into patch_size x patch_size
    patches embedded to ``embed_dim`` and LayerNorm'd, then four stages of
    ``depths`` res-post-norm blocks (shifted-window cosine attention of
    ``num_heads`` heads over window x window tokens with a continuous
    position bias; an MLP of ``mlp_ratio`` x the width with the exact
    GELU), a 2 x 2 patch merging (width doubled) between stages. The latent
    is the mean of the last stage's tokens, 8 x ``embed_dim`` wide, without
    a final LayerNorm.

    The defaults are SatlasPretrain's Sentinel-2 Swin-v2-B
    (``Sentinel2_SwinB_SI_MS``: torchvision's ``swin_v2_b`` taking 9 bands,
    B04, B03, B02, B05, B06, B07, B08, B11, B12) at 512 px: the 8-bit TCI
    bands scaled by 1/255 and the 16-bit ones by 1/8160. Every stage's side
    must be a multiple of the window; a stage whose side equals the window
    is not shifted (torchvision's rule)."""

    img_size: int = 512
    patch_size: int = 4
    in_chans: int = 9
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-5
    band_scale: Tuple[float, ...] = (1 / 255,) * 3 + (1 / 8160,) * 6

    def __post_init__(self):
        if len(self.depths) != len(self.num_heads) or not self.depths:
            raise ValueError("depths and num_heads need one entry a stage")
        if self.img_size % self.patch_size:
            raise ValueError("img_size must be a multiple of patch_size")
        for i, (side, heads) in enumerate(zip(self.sides, self.num_heads)):
            width = self.embed_dim * 2 ** i
            if side % self.window_size or side < self.window_size:
                raise ValueError(
                    f"stage {i + 1} is {side} tokens wide, not a multiple of "
                    f"the window ({self.window_size}): torchvision pads "
                    "there, which this encoder does not")
            if width % heads:
                raise ValueError(f"stage {i + 1}'s width {width} is not a "
                                 f"multiple of its {heads} heads")
        if len(self.band_scale) != self.in_chans:
            raise ValueError(f"band_scale needs {self.in_chans} values, one "
                             "a band")

    @property
    def sides(self) -> Tuple[int, ...]:
        """Tokens along each side of each stage."""
        side = self.img_size // self.patch_size
        return tuple(side // 2 ** i for i in range(len(self.depths)))

    @property
    def widths(self) -> Tuple[int, ...]:
        """Each stage's width."""
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))

    @property
    def latent_dim(self) -> int:
        return self.widths[-1]

    def shift(self, stage: int, block: int) -> int:
        """The cyclic shift of a block: half the window in odd blocks, 0 in
        even ones and where the stage's side is the window."""
        if block % 2 == 0 or self.sides[stage] <= self.window_size:
            return 0
        return self.window_size // 2

    @property
    def chip_shape(self) -> Tuple[int, int, int]:
        """One chip's (bands, height, width)."""
        return (self.in_chans, self.img_size, self.img_size)


SATLAS_SWINV2B_S2MS = SwinConfig()


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
