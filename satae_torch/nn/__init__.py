"""Eval-mode layers on NHWC activations with PyTorch-layout weights."""
