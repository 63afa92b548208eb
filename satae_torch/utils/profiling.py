"""Debugging hooks: the counterpart of satae/utils/profiling.py's
``debug_mode``.

satae's ``RuntimeConfig.debug_nans`` runs ``fit`` under ``jax_debug_nans``,
which raises ``FloatingPointError`` at the first NaN a program produces. The
port has no such switch in PyTorch, so :func:`debug_mode` turns on a check in
the train steps instead: each step's loss is checked before its backward and
its gradients after it, and the first non-finite value raises
``FloatingPointError`` naming the step and the tensor. The check reads the
values back, one host sync per step, in this mode only.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch

_nans = False


@contextlib.contextmanager
def debug_mode(nans: bool = True) -> Iterator[None]:
    """Within the block, the train steps raise at a non-finite loss or
    gradient when ``nans`` is true."""
    global _nans
    prev, _nans = _nans, nans
    try:
        yield
    finally:
        _nans = prev


def check_finite(what: str, names: Sequence[str],
                 tensors: Sequence[torch.Tensor]) -> None:
    """Under :func:`debug_mode`, raise ``FloatingPointError`` at the first of
    ``tensors`` that holds a NaN or an infinity; a no-op otherwise."""
    if not _nans:
        return
    finite = torch.stack([torch.isfinite(t).all() for t in tensors]).tolist()
    for name, ok in zip(names, finite):
        if not ok:
            raise FloatingPointError(
                f"debug_nans: non-finite {name} in the {what}")
