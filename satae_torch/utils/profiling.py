"""Profiling and debugging hooks: the counterpart of
satae/utils/profiling.py.

* :func:`trace` -- a context manager that records the host and, on a card,
  the device timeline with ``torch.profiler`` and writes it into a
  directory as a Chrome trace that TensorBoard's profile plugin and
  Perfetto open (satae's wraps ``jax.profiler``).
* :func:`span` -- the program's own named ranges (``satae.serve``, the
  train step's phases, each hand-kernel launch), recorded only while a
  ``torch.profiler`` session is active: on the profiler's time line beside
  the kernels, and in a bounded store that :func:`spans` reads, with host
  times, counts and, for device spans, the card's time between the span's
  two CUDA events.
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
import itertools
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import torch
from torch.autograd.profiler import record_function

_nans = False
# idle time around a traced block on a card, s (see trace)
PAD_S = 0.05


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
    The block's :func:`span` ranges are on it. Raises if the profiler does
    not start.

    On a card the session opens with a short spin kernel and ``PAD_S`` of
    idle time before the block, and closes ``PAD_S`` after the card has
    finished it: the profiler was seen to lose the device records of work
    launched as a session opens."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    if not torch.autograd._profiler_enabled():
        prof.stop()
        raise RuntimeError("torch.profiler did not start")
    try:
        if cuda:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / (
            f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
            ".pt.trace.json")))


# -- spans -------------------------------------------------------------------
#
# A span is on while a torch.profiler session is active (the benchmark's
# traced window, trace above) and off otherwise, which is every untraced
# run and every user call: off, span() checks the profiler's state and
# returns one shared object that does nothing, so the program pays no
# record_function, allocation, CUDA event or sync for it.

SPAN_CAPACITY = 1 << 16


@dataclass(slots=True)
class SpanRecord:
    """One span: host times from ``time.perf_counter_ns()``; ``parent``,
    the id of the span open around it on the same thread (None at a
    thread's top, so kernel spans on autograd's backward thread have none);
    ``device_ms``, for a device span once :func:`spans` has read it, the
    card's time from reaching the span's first CUDA event to reaching its
    last (device idle inside the span included)."""
    name: str
    id: int
    parent: Optional[int]
    t0_ns: int
    t1_ns: Optional[int] = None
    counts: Dict[str, float] = field(default_factory=dict)
    device_ms: Optional[float] = None
    events: Optional[List[torch.cuda.Event]] = field(default=None,
                                                     repr=False)


class Spans(NamedTuple):
    """The store's records in the order they opened, and how many spans
    found it full and were not kept."""
    records: List[SpanRecord]
    dropped: int


class _Store:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> List[int]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def keep(self, rec: SpanRecord) -> None:
        with self.lock:
            if len(self.records) < self.capacity:
                self.records.append(rec)
            else:
                self.dropped += 1


_store = _Store(SPAN_CAPACITY)


class _Off:
    """The span while no profiler session is active: does nothing."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "counts", "rf", "rec")

    def __init__(self, name: str, device: bool, counts: Dict[str, float]):
        self.name, self.device, self.counts = name, device, counts

    def __enter__(self) -> SpanRecord:
        self.rf = record_function(self.name)
        self.rf.__enter__()
        stack = _store.stack()
        rec = self.rec = SpanRecord(
            self.name, next(_store.ids), stack[-1] if stack else None,
            time.perf_counter_ns(), counts=self.counts)
        if self.device:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec.events = [ev]
        _store.keep(rec)
        stack.append(rec.id)
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        try:
            if rec.events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                rec.events.append(ev)
            rec.t1_ns = time.perf_counter_ns()
            _store.stack().pop()
        finally:
            self.rf.__exit__(*exc)
        return False


def span(name: str, *, device: bool = False, **counts: float):
    """A context manager around one piece of the program's work, recorded
    while a ``torch.profiler`` session is active and a no-op otherwise (a
    session is active on the thread that opened it and on the autograd
    threads that run its backward).

    On, it enters ``record_function(name)``, which puts the range on the
    profiler's time line beside the card's kernels and copies, and keeps a
    :class:`SpanRecord` with ``counts`` (say ``bytes=...``) in the store
    :func:`spans` reads. With ``device=True`` it also records a CUDA event
    on the current stream at entry and at exit; they are read, not waited
    for, when :func:`spans` is called. A span never synchronizes and never
    resets the card's memory statistics."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device, counts)


def spans() -> Spans:
    """The spans recorded so far, each closed device span's ``device_ms``
    filled in: waits here, and only here, for the card to reach their
    events."""
    with _store.lock:
        records, dropped = list(_store.records), _store.dropped
    pending = [r for r in records
               if r.events is not None and len(r.events) == 2]
    for r in pending:
        r.events[1].synchronize()
    for r in pending:
        r.device_ms = r.events[0].elapsed_time(r.events[1])
        r.events = None
    return Spans(records, dropped)


def reset_spans() -> None:
    """Empty the store and its count of dropped spans."""
    with _store.lock:
        _store.records.clear()
        _store.dropped = 0


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
