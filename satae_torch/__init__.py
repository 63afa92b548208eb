"""PyTorch/CUDA port of satae for NVIDIA Hopper GPUs (see README.md).

``satae_torch.fit`` trains the pipeline (the grid sweeps or the single
reference config, optionally into a run directory in satae's format), and
``satae_torch.SatAEPipeline`` loads, saves, evaluates or serves a fitted one
(``encode``, ``predict``) on hand-written CUDA kernels
(``satae_torch.kernels``), with the autoencoder's encoder or a frozen ViT
encoder (``ViTConfig``; ``PRITHVI_EO1_100M``; ``SwinConfig``;
``SATLAS_SWINV2B_S2MS``). It imports neither JAX nor
the ``satae`` package.
"""

from satae_torch.api import (FitSummary, SatAEPipeline, encode,  # noqa: F401
                             fit, predict)
from satae_torch.config import (  # noqa: F401
    EUROSAT_CLASSES,
    AETrainConfig,
    DataConfig,
    MLPTrainConfig,
    ModelConfig,
    PipelineConfig,
    PRITHVI_EO1_100M,
    RuntimeConfig,
    SATLAS_SWINV2B_S2MS,
    SwinConfig,
    ViTConfig,
    default_config,
)
