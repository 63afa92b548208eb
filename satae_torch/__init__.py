"""PyTorch/CUDA port of satae for NVIDIA Hopper GPUs (see README.md).

This slice serves: ``satae_torch.api.SatAEPipeline`` loads a fitted
pipeline and runs encode / predict on hand-written CUDA kernels
(``satae_torch.kernels``). It imports neither JAX nor the ``satae`` package.
"""
