"""What the program's own spans (``satae_torch.utils.profiling.span``)
recorded in a run's traced window, for the per-layer readers that read them.

A span is recorded only while a profiler session is active, so only a
traced run has any. The window's spans are those whose host start lies
between the first unit's start and the last unit's end (``run.units``, on
the same ``time.perf_counter`` clock): a capture that ``portbench.trace``
took once more leaves the spans of its first try outside. Each function
returns None where there is nothing sound to read: no trace, a program
without spans (one older than them), no span of the name, or a store that
dropped records, whose sums would come out short.
"""

from __future__ import annotations

from typing import List, Optional


def window(run) -> Optional[list]:
    """The window's span records, in the order they opened; None as
    above."""
    if run.trace is None or not run.units:
        return None
    try:
        from satae_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    got = read()
    if got.dropped:
        return None
    lo, hi = run.units[0][0], run.units[-1][1]
    return [r for r in got.records if lo <= r.t0_ns * 1e-9 <= hi]


def named(run, name: str) -> Optional[List]:
    """The window's records of span ``name``; None if there are none."""
    recs = window(run)
    if recs is None:
        return None
    mine = [r for r in recs if r.name == name]
    return mine or None


def device_ms_per(run, name: str, unit: str) -> Optional[float]:
    """Sum of the card's time inside the window's spans ``name`` over
    ``run.totals[unit]`` (``calls`` or ``steps``), ms; None if a span has
    no device time."""
    recs = named(run, name)
    per = run.totals.get(unit)
    if recs is None or not per or any(r.device_ms is None for r in recs):
        return None
    return sum(r.device_ms for r in recs) / per
