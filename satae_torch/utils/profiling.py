"""Profiling and debugging hooks: the counterpart of
satae/utils/profiling.py.

* :func:`trace` -- a context manager that records the host and, on a card,
  the device timeline with ``torch.profiler`` and writes it into a
  directory as a Chrome trace that TensorBoard's profile plugin and
  Perfetto open (satae's wraps ``jax.profiler``).
* :class:`Stopwatch` -- a named wall-clock stage timer with a report dict,
  satae's own.
* :func:`debug_mode` -- satae's ``RuntimeConfig.debug_nans`` runs ``fit``
  under ``jax_debug_nans``, which raises ``FloatingPointError`` at the first
  NaN a program produces. The port has no such switch in PyTorch, so
  :func:`debug_mode` turns on a check in the train steps instead: each
  step's loss is checked before its backward and its gradients after it,
  and the first non-finite value raises ``FloatingPointError`` naming the
  step and the tensor. The check reads the values back, one host sync per
  step, in this mode only.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Dict, Iterator, Sequence

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


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the block: host activity, and the card's kernels where a
    card is present. On exit the timeline is written to ``log_dir``
    (created) as ``<host>_<pid>.<ns>.pt.trace.json``, the name TensorBoard's
    profile plugin looks for; Perfetto and chrome://tracing open it too.
    Raises if the profiler does not start."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    if not torch.autograd._profiler_enabled():
        prof.stop()
        raise RuntimeError("torch.profiler did not start")
    try:
        yield prof
    finally:
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / (
            f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
            ".pt.trace.json")))


class Stopwatch:
    """Named stage timer: ``with sw.stage("train"): ...``, then
    ``sw.report()``; a repeated stage adds to its time."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + \
                time.perf_counter() - t0

    def report(self) -> Dict[str, float]:
        """Seconds per stage, rounded to 3 decimals."""
        return {k: round(v, 3) for k, v in self.times.items()}
