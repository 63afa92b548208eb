"""Strict-JSON serialization: the port's copy of satae/utils/strict_json.py.

Python's json module emits the non-standard ``Infinity``/``NaN`` literals
for non-finite floats, which strict parsers reject. Diverged grid configs
produce inf/NaN selection metrics, so every persisted artifact goes through
these helpers: non-finite floats are written as the strings
``"inf"``/``"-inf"``/``"nan"`` and restored to floats on load
(``float("inf")`` parses them, so ``float(meta[...])`` readers work
unchanged). The files are the same bytes satae writes, so a run directory
is shared by both packages.

The encoding is schema-free: a string field whose value is exactly
"inf"/"-inf"/"nan" would come back as a float. No artifact stores such
strings.
"""

from __future__ import annotations

import json
import math
from typing import Any

_NONFINITE_STRS = ("inf", "-inf", "nan")


def json_sanitize(obj: Any) -> Any:
    """Replace non-finite floats with their string forms recursively."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def json_restore(obj: Any) -> Any:
    """Inverse of :func:`json_sanitize` ('inf' -> float('inf') etc.)."""
    if isinstance(obj, dict):
        return {k: json_restore(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [json_restore(v) for v in obj]
    if isinstance(obj, str) and obj in _NONFINITE_STRS:
        return float(obj)
    return obj


def dump_strict_json(obj: Any, **kwargs) -> str:
    """json.dumps that never emits non-standard Infinity/NaN literals."""
    return json.dumps(json_sanitize(obj), allow_nan=False, **kwargs)
