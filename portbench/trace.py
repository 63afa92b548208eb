"""The traced window: ``torch.profiler`` over a fixed number of units of work,
reduced to what the per-layer readers and the ``breakdown`` need.

The capture is the guarded one of ``chip_smoke.py`` (``profile_device``,
``device_records``, ``whole_calls``, ``top_ops``), copied here: the session
opens with a spin kernel (its record left out) and 50 ms of idle time before
the window and closes with 50 ms after it, and a capture counts only if
every unit's device records came back, each operation's name a whole number
of times per unit. torch.profiler was seen to lose the records of whole
calls as a session opens; a capture that lost some is taken once more, and
a second loss fails the run.

The window is the span ``portbench.window`` that the harness records around
the units, on the profiler's own time line. Device time is the union of the
intervals of kernels and copies on the card; an idle gap is a stretch of
the window with neither, named by the innermost host operation running at
its middle.
"""

from __future__ import annotations

import collections
import heapq
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

PAD_S = 0.05
WINDOW = "portbench.window"
TOP = 10


class TraceLost(RuntimeError):
    """The profiler lost device records of some unit, twice."""


@dataclass
class Trace:
    window_s: float
    busy_s: float            # kernels and copies
    kernel_busy_s: float     # kernels alone
    kernels: int
    copies: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _kind(name: str) -> str:
    """kernel, or the copy's direction (``HtoD``, ``DtoH``, ``DtoD``, ...),
    or ``memset``."""
    if name.startswith("Memcpy"):
        return name.split()[1]
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _length(merged) -> float:
    return sum(hi - lo for lo, hi in merged)


def whole(records, units: int) -> bool:
    """Whether every unit's records came back: each device operation's name
    a whole number of times per unit, and at least one name."""
    names = collections.Counter(name for name, _, _ in records)
    return bool(names) and all(c % units == 0 for c in names.values())


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle time by the innermost host operation running at each
    gap's middle (the one of latest start among those still running), or
    ``(no host op)``. ``host``: (start, end, name) sorted by start."""
    by = collections.Counter()
    active: List[Tuple[float, float, str]] = []  # heap on -start
    i = 0
    for lo, hi in sorted(gaps):
        mid = (lo + hi) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        by[active[0][2] if active else "(no host op)"] += (hi - lo) * 1e-6
    return by


def reduce(events) -> Optional[Tuple[Trace, list]]:
    """A Trace of profiler ``events``, and the device records
    [(name, start_us, end_us)]; None without the window's span."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW
           and e.device_type == DeviceType.CPU]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    records, host = [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the window's own span shows on the device's time line too
            # (a user annotation), and is no work
            if e.name == WINDOW or getattr(e, "is_user_annotation", False) \
                    or e.name.startswith("Activity Buffer") \
                    or "spin_kernel" in e.name or hi < w0 or lo > w1:
                continue
            records.append((e.name, max(lo, w0), min(hi, w1)))
        elif e.name != WINDOW and hi >= w0 and lo <= w1:
            host.append((lo, hi, e.name))
    host.sort()
    merged = _union([(lo, hi) for _, lo, hi in records])
    kernel = _union([(lo, hi) for n, lo, hi in records
                     if _kind(n) == "kernel"])
    gaps, at = [], w0
    for lo, hi in merged:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if w1 > at:
        gaps.append((at, w1))
    copies: Dict[str, Tuple[int, float]] = {}
    by_op = collections.Counter()
    for n, lo, hi in records:
        k = _kind(n)
        by_op[n] += (hi - lo) * 1e-6
        if k != "kernel":
            c, s = copies.get(k, (0, 0.0))
            copies[k] = (c + 1, s + (hi - lo) * 1e-6)
    named = _name_gaps(gaps, host)
    trace = Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=_length(merged) * 1e-6,
        kernel_busy_s=_length(kernel) * 1e-6,
        kernels=sum(1 for n, _, _ in records if _kind(n) == "kernel"),
        copies=copies,
        device_ops=[[n[:200], s] for n, s in by_op.most_common(TOP)],
        idle_gaps=[[n[:200], s] for n, s in named.most_common(TOP)])
    return trace, records


def capture(run_units: Callable[[], None], units: int) -> Trace:
    """Run ``run_units`` (``units`` units of work) under the profiler, with
    the guard above; retried once if records were lost."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    short = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            with record_function(WINDOW):
                run_units()
                torch.cuda.synchronize()
            time.sleep(PAD_S)
        got = reduce(prof.events())
        if got is not None and whole(got[1], units):
            return got[0]
        counts = collections.Counter(n for n, _, _ in got[1]) if got else {}
        short = [(n[:80], c) for n, c in counts.items() if c % units][:5]
    raise TraceLost(f"the profiler lost device records of some of the "
                    f"{units} units twice; counts not a multiple of the "
                    f"units: {short}")
