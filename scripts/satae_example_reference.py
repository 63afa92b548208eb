"""satae's own run of its end-to-end example on the CPU: the reference that
chip_smoke.py's phase 29 holds examples/reproduce_reference_torch.py to.

Runs ``examples/reproduce_reference.py --quick --synthetic-difficulty
hard`` (satae on JAX's CPU backend) into a temporary directory and records
its ``final.json`` -- test accuracy, the AE and MLP winners, the
calibration median, each stage's seconds -- and beside it the port's
example with the same flags and ``--device cpu`` (the plain kernel
versions), as a witness of the gap on one machine.

Writes ``scripts/satae_example_quick_hard.json``.

Usage: JAX_PLATFORMS=cpu python scripts/satae_example_reference.py
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "scripts" / "satae_example_quick_hard.json"
FLAGS = ["--quick", "--synthetic-difficulty", "hard"]


def run(script: str, extra: list) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, str(REPO / "examples" / script), *FLAGS,
               "--out", tmp, *extra]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, cwd=str(REPO), stdout=subprocess.DEVNULL,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
        wall = time.perf_counter() - t0
        final = json.loads((Path(tmp) / "final.json").read_text())
    return {"command": " ".join([f"examples/{script}", *FLAGS, *extra]),
            "wall_s": wall, **final}


def main() -> None:
    import jax
    import torch

    out = {"host": platform.processor() or platform.machine(),
           "cpus": os.cpu_count(), "jax": jax.__version__,
           "torch": torch.__version__,
           "satae": run("reproduce_reference.py", []),
           "port_cpu": run("reproduce_reference_torch.py",
                           ["--device", "cpu"])}
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
