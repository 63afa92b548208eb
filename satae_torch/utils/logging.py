"""Metrics registry: the port's copy of satae/utils/logging.py.

Every record is printed and appended to a JSONL file as strict JSON, so runs
are machine-readable; an instance is also the plain log callback the
trainers accept.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

from satae_torch.utils.strict_json import dump_strict_json, json_restore


class MetricsLogger:
    def __init__(self, path: Optional[str | Path] = None, *,
                 stream=None, echo: bool = True):
        self.path = Path(path) if path else None
        # None = look up sys.stdout at each write, so a stream replaced after
        # construction (a test's capture) is the one written to
        self._stream = stream
        self.echo = echo
        self._t0 = time.time()
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    @property
    def stream(self):
        return self._stream if self._stream is not None else sys.stdout

    def log(self, record: Dict[str, Any], **extra: Any) -> None:
        rec = {"t": round(time.time() - self._t0, 3), **record, **extra}
        if self.path:
            with self.path.open("a") as f:
                f.write(dump_strict_json(rec) + "\n")
        if self.echo:
            parts = [f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in rec.items()]
            print("  ".join(parts), file=self.stream, flush=True)

    def __call__(self, msg_or_record) -> None:
        """The plain log callback: a dict is a record, anything else a
        message line."""
        if isinstance(msg_or_record, dict):
            self.log(msg_or_record)
        else:
            if self.path:
                with self.path.open("a") as f:
                    f.write(json.dumps({"t": round(time.time() - self._t0, 3),
                                        "msg": str(msg_or_record)}) + "\n")
            if self.echo:
                print(msg_or_record, file=self.stream, flush=True)


def read_jsonl(path: str | Path):
    """Inverse of MetricsLogger's strict-JSON writes: 'inf'/'nan' metric
    strings come back as floats."""
    return [json_restore(json.loads(line))
            for line in Path(path).read_text().splitlines() if line.strip()]
