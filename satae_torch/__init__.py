"""PyTorch/CUDA port of satae for NVIDIA Hopper GPUs (see README.md).

``satae_torch.fit`` trains the single-config pipeline and
``satae_torch.SatAEPipeline`` loads or serves a fitted one (encode, predict)
on hand-written CUDA kernels (``satae_torch.kernels``). It imports neither
JAX nor the ``satae`` package.
"""

from satae_torch.api import FitSummary, SatAEPipeline, fit  # noqa: F401
