"""Serving's upload, this tree against another in one process: the other
tree's ``satae_torch/api.py`` is loaded beside this tree's (every other file
of its ``satae_torch`` must equal this tree's, so the two pipelines differ
in ``api.py`` alone and share the built kernels). For each case, both
pipelines serve the same page-locked (or pageable) images with the same
weights; their answers are held bitwise equal, then timed in alternating
pairs of windows (other, this; this, other; ...). Then a few calls of each
are profiled: per call, the host-to-device copy time, the part of it that
ran while a kernel ran, the kernels' busy time and the traced call.

Cases: float32 and bf16 (its throughput batch 1024) on a 29,241-patch tile,
page-locked and pageable; float32 on 64-image calls. Full-width model
(random weights), 64x64x3 uint8 patches.

Usage (one CUDA card; the other tree unpacked with ``git archive``):
    python3 scripts/time_serve_upload.py --other .archive/parent
Prints the card line first and writes chiprun_out/serve_upload.json.
``--device cpu --tile 300`` rehearses the script on the CPU at a tiny size
(pageable memory only, no profile).
"""

from __future__ import annotations

import argparse
import filecmp
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def other_api(root: Path):
    """The other tree's api module, on this tree's other modules."""
    mine, theirs = REPO / "satae_torch", root / "satae_torch"
    differ = [str(p.relative_to(mine)) for p in sorted(mine.rglob("*.py"))
              if p.name != "api.py" and "_build" not in p.parts
              and not filecmp.cmp(p, theirs / p.relative_to(mine),
                                  shallow=False)]
    if differ:
        raise SystemExit(f"the trees differ beyond api.py: {differ}")
    spec = importlib.util.spec_from_file_location("other_api",
                                                  theirs / "api.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_api"] = mod  # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    return mod


def window(pipe, x, calls: int, sync) -> float:
    """Images a second over ``calls`` back-to-back calls."""
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        pipe.predict(x)
    return calls * len(x) / (time.perf_counter() - t0)


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2],
            "spread": (q[2] - q[0]) / statistics.median(v)}


def union(iv):
    out = []
    for lo, hi in sorted(iv):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def profile_calls(pipe, x, calls: int) -> dict:
    """Per call, ms: HtoD copies, the part of them under a kernel, kernels'
    busy time, and the traced call (window over calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        for _ in range(calls):
            pipe.predict(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.05)
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and "spin_kernel" not in e.name]
    htod = [(lo, hi) for n, lo, hi in dev if n.startswith("Memcpy HtoD")]
    kern = union([(lo, hi) for n, lo, hi in dev
                  if not n.startswith(("Memcpy", "Memset"))])
    under = sum(max(0.0, min(hi, khi) - max(lo, klo))
                for lo, hi in htod for klo, khi in kern)
    per = 1e-3 / calls
    return {"htod_ms": sum(hi - lo for lo, hi in htod) * per,
            "htod_under_kernels_ms": under * per,
            "htod_copies": len(htod) / calls,
            "kernel_busy_ms": sum(hi - lo for lo, hi in kern) * per,
            "traced_call_ms": wall * 1e3 / calls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tile", type=int, default=171 * 171)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--cases", default="",
                    help="comma-separated case names (default: all)")
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "serve_upload.json")
    args = ap.parse_args(argv)

    import torch

    from satae_torch import api
    from satae_torch import config as C
    from satae_torch.models.mlp import MLP
    from satae_torch.models.supervised_ae import SupervisedAE

    card = args.device == "cuda"
    if card:
        import chip_smoke
        line = chip_smoke.card_line()
        print(line, flush=True)
        sync = torch.cuda.synchronize
    else:
        line, sync = "cpu", (lambda: None)
    other = other_api(args.other)
    dev = torch.device(args.device)
    g = torch.Generator(device=dev).manual_seed(11)
    tile = torch.randint(0, 256, (args.tile, 64, 64, 3), dtype=torch.uint8,
                         generator=g, device=dev).cpu()
    pinned = torch.empty(tile.shape, dtype=tile.dtype, pin_memory=card)
    pinned.copy_(tile)
    small = 1 if card else 0.02
    cases = [  # name, dtype, images, calls a window, pairs
        ("bf16_tile_pinned", "bfloat16", pinned.numpy(), 40, args.pairs),
        ("f32_tile_pinned", "float32", pinned.numpy(), 12, args.pairs),
        ("f32_64_pinned", "float32", pinned.numpy()[:64], 400, args.pairs),
        ("bf16_tile_pageable", "bfloat16", tile.numpy(), 12,
         max(2, args.pairs // 2)),
        ("f32_tile_pageable", "float32", tile.numpy(), 6,
         max(2, args.pairs // 2)),
    ]
    if args.cases:
        cases = [c for c in cases if c[0] in args.cases.split(",")]
    res = {"card": line, "other": str(args.other), "cases": {}}
    for name, dtype, x, calls, pairs in cases:
        calls = max(1, int(calls * small))
        cfg = C.PipelineConfig(runtime=C.RuntimeConfig(compute_dtype=dtype))
        if dtype == "bfloat16":
            cfg = C.throughput_config(cfg, 1024)
        torch.manual_seed(0)
        ae = SupervisedAE(cfg.model, 3, 64).to(dev).eval()
        mlp = MLP(cfg.model).to(dev).eval()
        pipes = {}
        for side, mod in (("other", other), ("this", api)):
            p = mod.SatAEPipeline(cfg, device=dev)
            p.ae, p.mlp = ae, mlp
            pipes[side] = p
        answers = {s: (p.predict(x), p.encode(x)) for s, p in pipes.items()}
        equal = all((answers["this"][i] == answers["other"][i]).all()
                    for i in range(2))
        rates = {"other": [], "this": []}
        for k in range(pairs):
            order = ("other", "this") if k % 2 == 0 else ("this", "other")
            for s in order:
                rates[s].append(window(pipes[s], x, calls, sync))
        ratios = [t / o for t, o in zip(rates["this"], rates["other"])]
        got = {"images": len(x), "calls_a_window": calls,
               "slices": len(api.upload_slices(
                   len(x), pipes["this"]._serve_chunk(len(x)),
                   card and torch.from_numpy(x).is_pinned())),
               "bitwise_equal": bool(equal), "images_per_s": rates,
               "other": quartiles(rates["other"]),
               "this": quartiles(rates["this"]),
               "ratio_median": statistics.median(ratios),
               "ratios": ratios}
        if card:
            got["profile"] = {s: profile_calls(p, x, min(calls, 10))
                              for s, p in pipes.items()}
        res["cases"][name] = got
        print(name, json.dumps({k: v for k, v in got.items()
                                if k not in ("images_per_s", "ratios")}),
              flush=True)
        del pipes, answers
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    ok = all(c["bitwise_equal"] for c in res["cases"].values())
    print("ok" if ok else "ANSWERS DIFFER", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
