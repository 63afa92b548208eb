"""The benchmark of the PyTorch and CUDA port (``satae_torch``) on one
NVIDIA H100: ``python3 portbench/run.py --workload <cell> ...``."""
