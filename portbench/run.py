"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything the run needs it finds by name: the cell in ``BENCHMARK.json``
names its configuration (``portbench/configs/<config>.json``) and its
traffic (``portbench/traffic/<traffic>.json``); the traffic names its kind
(``portbench/kinds/<kind>.py``: set-up, one unit of work, the work model and
the check); the cell's limits are ``portbench/limits/<cell>.json``; every
metric is read by ``portbench/metrics/<metric>.py``. A later cell, traffic
or metric is new files and new entries, with no edit here.

A run makes its inputs from ``--seed``, sets up and warms every shape the
window uses (``setup_s``: from the start of the process to the first timed
unit), then with ``--trace 0`` runs units of work back to back for
``--seconds`` and reports the cell's end-to-end metrics, or with
``--trace 1`` runs the traffic's ``trace_units`` under the profiler
(portbench.trace) and reports its per-layer metrics. Then it frees the
program's state and judges what the program produced against the plain
reference (portbench.reference); each number compared is printed beside its
limit on standard error and last in the result line.

It refuses to run without as many CUDA cards as the cell asks for, and it
fails if the process holds ``jax``, ``jaxlib``, ``flax`` or ``satae`` once
the window has closed. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "satae")
CACHE = ROOT / ".portbench_cache"


def _cache_env() -> None:
    """Kernel caches of PyTorch and the CUDA driver at fixed paths inside
    the checkout (the program's nvcc builds already live there, under
    satae_torch/_build)."""
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          str(CACHE / "torch_kernels"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "cuda"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))


# the checkout's root on the path, and not this folder, whose module names
# (trace, work, run) would shadow others
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    limits: Dict[str, float]
    seed: int
    device: Any = None


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    setup_s: float
    window_s: float
    units: List[Tuple[float, float, Dict[str, int]]]
    work: Dict[str, float]           # per unit: flops, least_s
    peak: Optional[Dict[str, float]]
    trace: Any = None                # portbench.trace.Trace
    totals: Dict[str, int] = field(default_factory=dict)


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, seed: int) -> Cell:
    man = load_manifest()
    ent = {w["name"]: w for w in man["workloads"]}.get(name)
    if ent is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_file = {c["name"]: c["file"] for c in man["configs"]}[ent["config"]]
    read = lambda p: json.loads((ROOT / p).read_text())
    return Cell(name, read(cfg_file),
                read(f"portbench/traffic/{ent['traffic']}.json"),
                ent["chips"], read(f"portbench/limits/{name}.json"), seed)


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell: str, traced: bool) -> List[dict]:
    """The manifest's metrics this cell reports in a run of this kind:
    end-to-end ones untraced, per-layer ones traced; a metric with a
    ``workloads`` list only in those cells, a per-layer one without it in
    every cell that reports the end-to-end metric it moves."""
    man = load_manifest()
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not traced:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in mine)]


def read_metrics(run: Run, wanted: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in wanted:
        value = _module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(cell: Cell, trace) -> dict:
    import torch

    info = {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}
    if cell.device is not None and cell.device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(cell.device),
                "count": cell.chips,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(cell.device))}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float = T_START, edit=None, keep: bool = False):
    """One run of cell ``name``: the result dict (the contract's keys and
    ``checks``), with ``keep`` also the session, for a control to be judged
    against the same reference. ``edit(cell)`` may change the loaded cell
    first (the tests' small sizes)."""
    import torch

    from portbench import trace as T
    from portbench import work as W

    cell = load_cell(name, seed)
    cell.device = torch.device(device)
    if edit is not None:
        edit(cell)
    kind = _module("kinds", cell.traffic["kind"])
    session = kind.setup(cell)
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    setup_s = time.perf_counter() - t_start

    units: List[Tuple[float, float, Dict[str, int]]] = []

    def one():
        a = time.perf_counter()
        got = session.unit()
        units.append((a, time.perf_counter(), got))

    trace = None
    if traced:
        n = cell.traffic["trace_units"]

        def run_units():
            units.clear()
            for _ in range(n):
                one()
        trace = T.capture(run_units, n)
        window_s = trace.window_s
    else:
        w0 = time.perf_counter()
        while True:
            one()
            if units[-1][1] - w0 >= seconds:
                break
        window_s = units[-1][1] - w0
    totals: Dict[str, int] = {}
    for _, _, got in units:
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
    dev_name = (torch.cuda.get_device_name(cell.device)
                if cell.device.type == "cuda" else "cpu")
    peak = W.peaks(dev_name, cell.config["compute_dtype"])
    run = Run(cell, setup_s, window_s, units,
              session.work(peak) if peak else {}, peak, trace, totals)
    metrics = read_metrics(run, metrics_of(name, traced))
    device = device_info(cell, trace)

    session.release()
    numbers, wrong = session.compare(session.outputs(), cell.limits)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = all(v <= cell.limits[k] for k, v in numbers.items())
    attempted = totals.get("calls", totals.get("steps", 0)) \
        + session.first_steps
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(wrong), "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = checks
    return (result, session) if keep else result


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``satae_torch`` is not ``satae``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    import torch

    cell = load_cell(args.workload, args.seed)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell asks for {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no run on the CPU)", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}: the port "
              "may load none of " + ", ".join(FORBIDDEN), file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
