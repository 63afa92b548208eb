"""The readings that a cell's limits are set from, on the card, in one
process: the numbers the check compares for sound runs of the program on
many seeds (the lower reading), for the control, the reference computed one
precision below the configuration's (portbench.reference.precision) in the
program's place, and for each fault of the cell's traffic kind
(``FAULTS`` of ``portbench/kinds/<kind>.py``) planted in the program (the
upper readings).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --fault-seeds 4,5,6 --seconds 2 \
        --out readings.json

Each seed runs ``portbench/run.py``'s whole run (set-up, a window of
``--seconds``, the check) in this process; the control is judged on the
same run's reference. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402
from portbench.reference import precision  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    run._cache_env()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload, 0)
    faults = run._module("kinds", cell.traffic["kind"]).FAULTS
    label, q = precision.BELOW[cell.config["compute_dtype"]]
    ctrl = set(_seeds(args.control_seeds))
    out = {"workload": args.workload, "control": label, "program": [],
           "control_runs": [], "faults": []}

    def save():
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        res, session = run.run_cell(args.workload, seed, args.seconds, False,
                                    "cuda", t_start=t0, keep=True)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        out["program"].append({"seed": seed, "numbers": nums,
                               "metrics": res["metrics"],
                               "detail": getattr(session, "detail", None)})
        print(f"program seed {seed}: {nums}", file=sys.stderr)
        if seed in ctrl:
            cn, _ = session.compare(session.control_outputs(q), cell.limits)
            out["control_runs"].append({
                "seed": seed, "numbers": cn,
                "detail": getattr(session, "detail", None)})
            print(f"control seed {seed}: {cn}", file=sys.stderr)
        del session
        torch.cuda.empty_cache()
        save()
    for seed in _seeds(args.fault_seeds):
        for fault, plant in faults.items():
            with plant():
                detail = None
                try:
                    res, session = run.run_cell(
                        args.workload, seed, args.seconds, False, "cuda",
                        keep=True)
                    nums = {k: v["value"] for k, v in res["checks"].items()}
                    detail = getattr(session, "detail", None)
                    del session
                except Exception as exc:  # a fault may crash the program
                    nums = {"error": repr(exc)[:300]}
            out["faults"].append({"seed": seed, "fault": fault,
                                  "numbers": nums, "detail": detail})
            print(f"fault {fault} seed {seed}: {nums}", file=sys.stderr)
            torch.cuda.empty_cache()
            save()
    save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
