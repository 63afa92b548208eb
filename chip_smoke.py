#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (satae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. card   -- requires a CUDA device; prints nvidia-smi's name and power limit.
2. build  -- compiles the hand-written kernels from satae_torch/csrc with nvcc
             (sm_90a) and prints the build seconds and the ptxas report.
3. K1     -- fused_gemm against fused_matmul_plain (TF32 off) at every K1
             shape of the serving path plus the awkward shapes of the JAX
             package's kernel tests, all three activations.
4. K2     -- conv2d_bn_act against conv2d_bn_act_plain at the four encoder
             layers of a 512-image chunk, non-trivial BatchNorm.
             Tolerance for both: |err| <= 1e-4 + 1e-5 * |ref| elementwise.
5. time   -- each kernel, its plain version and the one-call library
             equivalent, at the serving shapes, with CUDA events, beside the
             least time the card could take (from the H100 SXM data-sheet
             peaks: 67 TFLOP/s float32 without tensor cores, 3.35 TB/s).
6. serve  -- loads the committed full-width checkpoint
             benchmarks/full_run_hard_f32 through SatAEPipeline, rebuilds the
             synthetic-hard test split with the port's data modules, and runs
             predict on the card with the kernel launch counts zeroed before
             and read after. Test accuracy must be within 0.002 of the run's
             fit_summary.json; latents and predictions are held against the
             plain PyTorch modules on the same card (TF32 off). Then times
             predict (images/s) and profiles one predict call.

The second-to-last line holds the kernels' numbers as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CKPT = REPO / "benchmarks" / "full_run_hard_f32"
F32_PEAK = 67e12  # FLOP/s, H100 SXM, CUDA cores, dense
HBM_PEAK = 3.35e12  # bytes/s, H100 SXM
ACTS = ("none", "relu", "sigmoid")
CHUNK = 512


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float):
    """(ms, 'operations' | 'bytes'): the least time for the work."""
    t_ops, t_bytes = ops / F32_PEAK * 1e3, nbytes / HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(out, ref, what: str) -> float:
    import torch

    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"{what}: shape {tuple(out.shape)} vs "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    bad = int((err > 1e-4 + 1e-5 * ref.abs()).sum())
    check(bad == 0, f"{what}: {bad} elements outside 1e-4 + 1e-5*|ref| "
          f"(max |err| {float(err.max()):.3g})")
    return float(err.max())


def main() -> int:
    import numpy as np
    import torch

    # -- 1. card ------------------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    import torch.nn.functional as F

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import DataConfig, PipelineConfig
    from satae_torch.data.augment import normalize
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.kernels import _build
    from satae_torch.kernels.conv import conv2d_bn_act, conv2d_bn_act_plain
    from satae_torch.kernels.matmul import fused_matmul, fused_matmul_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({_build.build_dir()})", flush=True)
    print(_build.ptxas_report(), flush=True)

    # The plain versions are the reference: full float32, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, device=dev, generator=g) * (hi - lo) + lo

    def affine(n):
        return rand(n, lo=0.5, hi=1.5), rand(n, lo=-0.3, hi=0.3)

    # -- 3. K1 --------------------------------------------------------------
    # serving path at chunk 512: projection, fc0, fc1 (BN folded), fc2
    k1_path = [((CHUNK, 4096, 64), "none"), ((CHUNK, 64, 128), "relu"),
               ((CHUNK, 128, 64), "relu"), ((CHUNK, 64, 10), "none")]
    k1_shapes = [s for s, _ in k1_path] + [(64, 4096, 64), (64, 64, 128),
                                           (7, 33, 10), (1, 64, 10)]
    k1_err = 0.0
    for m, k, n in k1_shapes:
        x = torch.randn(m, k, device=dev, generator=g)
        w = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = affine(n)
        for act in ACTS:
            k1_err = max(k1_err, max_err(
                fused_matmul(x, w, scale, shift, act),
                fused_matmul_plain(x, w, scale, shift, act),
                f"K1 {(m, k, n)} {act}"))
    print(f"K1 fused_gemm vs plain: {len(k1_shapes) * 3} cases, max |err| "
          f"{k1_err:.3g}", flush=True)

    # -- 4. K2 --------------------------------------------------------------
    chans = (3, 32, 64, 128, 256)
    k2_path = [(CHUNK, 64 >> i, chans[i], chans[i + 1]) for i in range(4)]
    k2_inputs = []
    k2_err = 0.0
    for n, hw, cin, cout in k2_path + [(3, 7, 5, 9)]:
        x = rand(n, hw, hw, cin)
        w = rand(3, 3, cin, cout, lo=-1.0, hi=1.0) / (9 * cin) ** 0.5
        scale, shift = affine(cout)
        acts = ("relu",) if n == CHUNK else ACTS
        for act in acts:
            k2_err = max(k2_err, max_err(
                conv2d_bn_act(x, w, scale, shift, 2, 1, act),
                conv2d_bn_act_plain(x, w, scale, shift, 2, 1, act),
                f"K2 {(n, hw, hw, cin, cout)} {act}"))
        if n == CHUNK:
            k2_inputs.append((x, w, scale, shift))
    print(f"K2 conv2d_bn_act vs plain: 7 cases, max |err| {k2_err:.3g}",
          flush=True)

    # -- 5. time ------------------------------------------------------------
    rows = []
    for (m, k, n), act in k1_path:
        x = torch.randn(m, k, device=dev, generator=g)
        w = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = affine(n)
        b_ms, b_by = bound(2.0 * m * k * n, 4.0 * (m * k + k * n + 2 * n
                                                   + m * n))
        rows.append(dict(
            kernel="fused_gemm", shape=[m, k, n], act=act,
            ms=time_ms(lambda: fused_matmul(x, w, scale, shift, act)),
            plain_ms=time_ms(lambda: fused_matmul_plain(x, w, scale, shift,
                                                        act)),
            library_ms=time_ms(lambda: torch.matmul(x, w)),
            bound_ms=b_ms, bound_by=b_by))
    for (n, hw, cin, cout), (x, w, scale, shift) in zip(k2_path, k2_inputs):
        oh = hw // 2
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC data
        m, kk = n * oh * oh, 9 * cin
        b_ms, b_by = bound(2.0 * m * kk * cout,
                           4.0 * (x.numel() + w.numel() + 2 * cout
                                  + m * cout))
        rows.append(dict(
            kernel="conv2d_bn_act", shape=[n, hw, hw, cin, cout], act="relu",
            ms=time_ms(lambda: conv2d_bn_act(x, w, scale, shift, 2, 1,
                                             "relu")),
            plain_ms=time_ms(lambda: conv2d_bn_act_plain(x, w, scale, shift,
                                                         2, 1, "relu")),
            library_ms=time_ms(lambda: F.conv2d(x_nchw, w_oihw, shift,
                                                stride=2, padding=1)),
            bound_ms=b_ms, bound_by=b_by))
    for r in rows:
        print(f"  {r['kernel']:14s} {str(r['shape']):24s} "
              f"ms {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)

    # -- 6. serve -----------------------------------------------------------
    cfg = PipelineConfig(data=DataConfig(per_class=2000,
                                         synthetic_difficulty="hard"))
    t0 = time.perf_counter()
    test = make_splits(load_dataset(cfg.data), cfg.data).test
    data_s = time.perf_counter() - t0
    pipe = SatAEPipeline(cfg).load(str(CKPT))
    check(pipe.device.type == "cuda", f"pipeline on {pipe.device}")
    n_img = len(test)

    kernels.reset_launch_counts()
    preds = pipe.predict(test.images)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    n_chunks = -(-n_img // CHUNK)
    check(launches == {"fused_gemm": 4 * n_chunks,
                       "conv2d_bn_act": 4 * n_chunks},
          f"launches on the serving path {launches}, expected "
          f"{4 * n_chunks} of each")
    acc = float((preds == test.labels).mean())
    ref_acc = json.loads((CKPT / "fit_summary.json").read_text())["test_acc"]
    print(f"predict: {n_img} test images, accuracy {acc:.6f} "
          f"(recorded {ref_acc:.6f}), launches {launches}", flush=True)
    check(abs(acc - ref_acc) <= 0.002,
          f"accuracy {acc} vs recorded {ref_acc}")

    z = pipe.encode(test.images)
    check(z.shape == (n_img, cfg.model.latent_dim), f"latents {z.shape}")
    with torch.no_grad():
        x = normalize(torch.from_numpy(test.images).to(dev))
        z_plain = pipe.ae.enc(x)
        preds_plain = torch.argmax(pipe.mlp(z_plain), dim=-1).cpu().numpy()
    z_plain = z_plain.cpu().numpy()
    dz = float(abs(z - z_plain).max())
    agree = float((preds == preds_plain).mean())
    print(f"kernel path vs plain modules on the card: max |dz| {dz:.3g}, "
          f"predictions agree {agree:.6f}", flush=True)
    check(dz <= 1e-3, f"latents differ from the plain path by {dz}")
    check(agree >= 0.999, f"predictions agree on {agree} only")

    few = test.images[:10]  # the small-chunk (64) program
    proba = pipe.predict_proba(few)
    check(proba.shape == (10, cfg.model.num_classes)
          and bool(np.allclose(proba.sum(axis=1), 1.0, atol=1e-5))
          and bool((proba.argmax(axis=1) == preds[:10]).all()),
          "predict_proba on 10 images disagrees with predict")

    pipe.predict(test.images)  # warm-up
    reps = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        pipe.predict(test.images)
    end.record()
    end.synchronize()
    predict_ms = start.elapsed_time(end) / reps
    ips = n_img / (predict_ms / 1e3)
    print(f"predict: {ips:.1f} images/s ({predict_ms:.3f} ms per call of "
          f"{n_img} images); data generation {data_s:.2f} s on the host; "
          f"card {card}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.predict(test.images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device work = kernel and memcpy events on the card; busy time is the
    # union of their intervals. CUPTI's "Activity Buffer Request" marks the
    # profiler's own buffer handling, not work of the program.
    spans, by_name = [], {}
    layers = {"conv2d_bn_act_kernel": ("conv0", "conv1", "conv2", "conv3"),
              "fused_gemm_kernel": ("proj", "fc0", "fc1", "fc2")}
    seq = {k: [] for k in layers}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type != DeviceType.CUDA or \
                e.name.startswith("Activity Buffer"):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        for k in layers:
            if k in e.name:
                seq[k].append(e.time_range.elapsed_us())
    # each chunk launches conv0..conv3, then proj, fc0, fc1, fc2, in order
    per_layer_us = {lab: sum(seq[k][i::4]) / len(seq[k][i::4])
                    for k, labs in layers.items()
                    for i, lab in enumerate(labs)}
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    dev_ms = busy_us / 1e3
    top = sorted(((t / 1e3, c, k) for k, (t, c) in by_name.items()),
                 reverse=True)
    print(f"profile of one predict: wall {wall_ms:.3f} ms, device busy "
          f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - dev_ms / wall_ms):.1f}%", flush=True)
    for t, count, key in top[:8]:
        print(f"  {t:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    print("device us per launch: " + ", ".join(
        f"{k} {v:.1f}" for k, v in per_layer_us.items()), flush=True)

    # -- report -------------------------------------------------------------
    def entry(name, source, replaces, err):
        rs = [r for r in rows if r["kernel"] == name]
        ops_ms = sum(r["bound_ms"] for r in rs
                     if r["bound_by"] == "operations")
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "tolerance": "1e-4 + 1e-5*|ref|",
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": ("operations" if 2 * ops_ms >= sum(
                r["bound_ms"] for r in rs) else "bytes"),
            "library_ms": sum(r["library_ms"] for r in rs),
            "per": f"one {CHUNK}-image chunk ({len(rs)} launches)",
        }

    report = {"kernels": [
        entry("fused_gemm", "satae_torch/csrc/fused_gemm.cu",
              "satae/kernels/matmul.py:36", k1_err),
        entry("conv2d_bn_act", "satae_torch/csrc/conv_bn_act.cu",
              "satae/kernels/conv.py:36", k2_err)]}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, build_s=build_s, rows=rows,
        accuracy=acc, recorded_accuracy=ref_acc, max_dz=dz, agree=agree,
        predict_images_per_s=ips, predict_ms=predict_ms, n_images=n_img,
        data_s=data_s, profile_wall_ms=wall_ms, profile_device_ms=dev_ms,
        profile_top=top[:20], profile_us_per_launch=per_layer_us,
        **report), indent=1))
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
