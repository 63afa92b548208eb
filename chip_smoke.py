#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (satae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the smoke run, phases 1-12
    python3 chip_smoke.py --ab PARENT_DIR  # A/B of the kernels' times
    python3 chip_smoke.py --split-sweep    # K1's time for each split count

Phases, in order; any failure exits non-zero:

1. card   -- requires a CUDA device; prints nvidia-smi's name and power limit.
2. build  -- compiles the hand-written kernels from satae_torch/csrc with nvcc
             (sm_90a) and prints the build seconds and the ptxas report
             (registers, shared memory, spills per instantiation); fails on
             any spill.
3. K1     -- fused_gemm against fused_matmul_plain (TF32 off) at every K1
             shape of the serving path plus the awkward shapes of the JAX
             package's kernel tests and 8192x4096x64 (one split, all of K
             in one block), all three activations; then the split-K
             and ragged-K shapes (SPLIT_SHAPES) in every (trans_a, trans_b)
             layout and activation, with each shape's plan printed, and
             repeated calls held bitwise equal; a scale of the wrong length
             is refused.
4. K2     -- conv2d_bn_act against conv2d_bn_act_plain at the four encoder
             layers of a 512-image chunk, non-trivial BatchNorm, plus small
             convs with Cin % 4 != 0 (4-byte copies) and ragged 32/64-wide
             tiles; repeated calls at conv1 held bitwise equal.
             Tolerance for K1 and K2: |err| <= 1e-4 + 1e-5 * |ref|.
5. time   -- every K1 and K2 launch of a serving chunk: back-to-back ms
             (CUDA events) and device us per launch (torch.profiler) of the
             kernel and of the one-call library equivalent, the plain
             version's ms, and two bounds, the larger of bytes at 3.35 TB/s
             and operations at 165 TFLOP/s (3xTF32 on tensor cores: 495 / 3)
             or at 67 TFLOP/s (float32 on CUDA cores), H100 SXM data sheet.
6. serve  -- loads the committed full-width checkpoint
             benchmarks/full_run_hard_f32 through SatAEPipeline, rebuilds the
             synthetic-hard test split with the port's data modules, and runs
             predict on the card with the kernel launch counts zeroed before
             and read after. Test accuracy must be within 0.002 of the run's
             fit_summary.json; latents and predictions are held against the
             plain PyTorch modules on the same card (TF32 off). Then times
             predict (images/s) and profiles one predict call.
7. layouts -- fused_gemm (K1) with each (trans_a, trans_b) against
             fused_matmul_plain on the same operands, at every product of a
             batch-64 training step (forward, dX, dW of each linear layer)
             plus 7x33x10 and 1x64x10; tolerance as in 3.
8. bwd    -- K1's autograd function (nn.Linear weight layout) on the card:
             dx, dw, dscale, dshift against fused_matmul_bwd_plain and against
             autograd through fused_matmul_plain, three activations, scale
             requiring a gradient (the z recompute); then the linear layer's
             case, a constant scale: two backward launches, no dscale.
             Tolerance as in 3. The cotangent is zero where the pre-activation
             is within 1e-3 of relu's kink, whose side rounding decides.
9. parity -- 10 AE train steps at full width, batch 64, on the kernels, and
             the same 10 steps with the plain linears (layers.linear_plain):
             same init, same injected augmentation, deterministic cuDNN, TF32
             off, lr 1e-5. Per-step losses within 1e-3
             relative, first-step gradients within 1e-4 + 1e-3*|ref|
             elementwise, final parameters within 1e-3 relative L2 per
             tensor. The biases that feed a train-mode BatchNorm have an
             exact gradient of zero, so Adam moves them by rounding noise,
             and the BatchNorm betas start at zero, so one Adam sign flip is
             a large share of their norm: both are held to 2*lr*steps
             elementwise instead. Running variances are held like the
             parameters; running means, net of those biases' share, within
             1e-3 running standard deviations. Then 10 MLP steps
             the same way, with an injected dropout mask. Each run has a
             control beside it: the plain path from weights one ulp up. At
             larger rates (AE 1e-4 and the fit's 5e-3, MLP the fit's 1e-4)
             Adam's sign-like first steps carry any rounding difference far,
             the control's as far as the kernels': those runs are printed,
             not held.
10. fit   -- SatAEPipeline.fit(grid=False) on synthetic-hard per_class 2000
             at full width; the one cut is depth (AE 2 epochs of 80, MLP 2 of
             30). Launch counts zeroed before and read after must equal the
             counts derived from the steps, eval batches and extraction
             chunks; losses finite and falling, test accuracy above chance;
             then predict through the fitted pipeline, and the same fit
             again, which must repeat bit for bit (weights, summary).
11. train time -- each K1 launch of a batch-64 train step (forward and
             backward), measured as in 5; the AE and MLP epoch bodies' step
             times, the AE step with cuDNN's default and with its
             deterministic algorithms (fit's) in turns; a profile of a few
             AE steps each way.
12. grid  -- SatAEPipeline.fit(grid=True, out_dir=...) at the recorded
             cross-framework gate (benchmarks/torch_pipeline_parity.py):
             synthetic-hard per_class 256, full width, batch 64, seed 0, AE
             alpha (20, 35) x lr (1e-3, 5e-3) for 15 epochs with patience
             15, MLP lrs (1e-4, 1e-3, 1e-2) for 30 epochs. Launch counts
             zeroed before and read after must equal those derived from the
             configs, epochs, steps, eval batches, extraction chunks and
             test batches; the stores hold satae's keys in strict JSON; the
             winners are printed beside satae's recorded ones and the test
             accuracy held within 0.03 of satae's recorded 0.7947
             (benchmarks/torch_parity_pc256). A second fit on the same
             directory must train nothing (0 backward launches) and give
             the same summary and predictions; load + evaluate must score
             fit_summary.json's test accuracy; save + load and export_torch
             + load_torch must predict the same. Seconds per AE config and
             per MLP lr are printed with the card line.

The second-to-last line holds the kernels' numbers as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

``--ab PARENT_DIR`` times every K1 and K2 launch of phases 5 and 11 (ms and
device us per launch) in the tree at PARENT_DIR (another checkout of this
repository, with its own satae_torch) and in this one, in turns: parent,
this, this, parent, each in a process of its own that builds that tree's
kernels. It prints one line per launch and writes chiprun_out/ab.json.

``--split-sweep`` times K1 at the long-K products (the serving projection
512x4096x64 and the training one, 64x4096x64 with an (N, K) weight) for 1 to
64 splits on 32- and 64-wide tiles, each plan held against torch.matmul
within the tolerance above, beside the plan split_k_plan picks: the
measurement the plan rests on. It writes chiprun_out/split_sweep.json.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent
CKPT = REPO / "benchmarks" / "full_run_hard_f32"
F32_PEAK = 67e12  # FLOP/s, H100 SXM, CUDA cores, dense
TF32X3_PEAK = 495e12 / 3  # FLOP/s: 3xTF32, three TF32 products per product
HBM_PEAK = 3.35e12  # bytes/s, H100 SXM
ACTS = ("none", "relu", "sigmoid")
CHUNK = 512
BATCH = 64  # the training batch of the default DataConfig
PARITY_STEPS = 10
# K1 shapes that split K (split_k_plan), with ragged M, N and K
SPLIT_SHAPES = ((CHUNK, 4096, 64), (BATCH, 4096, 64), (BATCH, 4095, 64),
                (100, 4100, 70), (33, 1000, 10))
LAYOUTS = tuple(itertools.product((False, True), repeat=2))


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


def bounds(ops: float, nbytes: float) -> dict:
    """The least time for the work, ms: the larger of the bytes over the
    memory rate and the operations over the peak rate, at 3xTF32's
    (bound_ms, the kernels' arithmetic) and at float32's on CUDA cores
    (bound_f32_ms), each with what bounds it."""
    t_bytes = nbytes / HBM_PEAK * 1e3
    out = {}
    for key, peak in (("bound", TF32X3_PEAK), ("bound_f32", F32_PEAK)):
        t_ops = ops / peak * 1e3
        out[f"{key}_ms"] = max(t_ops, t_bytes)
        out[f"{key}_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


def device_us(fn, reps: int = 20) -> float:
    """Device time per call of ``fn``, us: the kernels (and copies) it puts
    on the card, summed over ``reps`` calls under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Activity Buffer")) / reps


def launch_specs():
    """Every K1 and K2 launch of the main paths: (path, layer, kind, args).
    Serving, per 512-image chunk: K2 conv0-3 (n, hw, cin, cout), then K1's
    projection and MLP layers (m, k, n, act). A batch-64 train step, AE and
    MLP: each linear layer's forward, dX and dW as K1 launches on the
    buffers the step holds -- (a shape, b shape, trans_a, trans_b);
    nn.Linear weights are (out, in)."""
    chans = (3, 32, 64, 128, 256)
    specs = [("serve", f"conv{i}", "k2", (CHUNK, 64 >> i, chans[i],
                                         chans[i + 1])) for i in range(4)]
    specs += [("serve", lab, "k1", (CHUNK, k, n, act)) for lab, k, n, act in (
        ("proj", 4096, 64, "none"), ("fc0", 64, 128, "relu"),
        ("fc1", 128, 64, "relu"), ("fc2", 64, 10, "none"))]
    for step, layers in (
            ("ae", [("proj", 4096, 64, True), ("dec_in", 64, 4096, True),
                    ("fc1", 64, 128, True), ("fc2", 128, 10, True)]),
            ("mlp", [("fc0", 64, 128, False), ("fc1", 128, 64, True),
                     ("fc2", 64, 10, True)])):
        for name, k, n, dx in layers:  # forward x (B, k) @ W^T, W (n, k)
            specs.append((step, f"{name} fwd", "k1t",
                          ((BATCH, k), (n, k), False, True)))
            if dx:
                specs.append((step, f"{name} dX", "k1t",
                              ((BATCH, n), (n, k), False, False)))
            specs.append((step, f"{name} dW", "k1t",
                          ((BATCH, n), (BATCH, k), True, False)))
    return specs


def kernel_rows(mods, reference: bool = True) -> list:
    """One row per launch of :func:`launch_specs`, on the kernels of
    ``mods`` (a namespace with fused_gemm and conv2d_bn_act, and with
    ``reference`` their plain versions too): back-to-back ms (CUDA events)
    and device us per launch (torch.profiler) of the kernel, both bounds,
    and with ``reference`` the plain version's ms and the one library call's
    ms and device us (torch.matmul, or cuDNN's F.conv2d with bias,
    channels-last; TF32 off)."""
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(*shape, device=dev, generator=g) * (hi - lo) + lo

    rows = []
    for path, layer, kind, args in launch_specs():
        if kind == "k2":
            n, hw, cin, cout = args
            x = rand(n, hw, hw, cin, lo=0.0)
            w = rand(3, 3, cin, cout) / (9 * cin) ** 0.5
            scale, shift = rand(cout, lo=0.5, hi=1.5), rand(cout, lo=-0.3,
                                                            hi=0.3)
            oh = hw // 2
            m, k = n * oh * oh, 9 * cin
            shape, trans, name = [n, hw, hw, cin, cout], None, "conv2d_bn_act"
            nbytes = 4.0 * (x.numel() + w.numel() + 2 * cout + m * cout)
            kern = lambda: mods.conv2d_bn_act(x, w, scale, shift, 2, 1,
                                              "relu")
            plain = lambda: mods.conv2d_bn_act_plain(x, w, scale, shift, 2,
                                                     1, "relu")
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of NHWC
            lib = lambda: F.conv2d(x_nchw, w_oihw, shift, stride=2, padding=1)
            n_out = cout
        else:
            if kind == "k1":
                m, k, n_out, act = args
                a, b = torch.randn(m, k, device=dev, generator=g), \
                    rand(k, n_out) / k ** 0.5
                ta = tb = False
                av, bv = a, b
            else:
                a_shape, b_shape, ta, tb = args
                act = "none"
                a = torch.randn(*a_shape, device=dev, generator=g)
                b = torch.randn(*b_shape, device=dev, generator=g)
                av, bv = (a.t() if ta else a), (b.t() if tb else b)
                m, k, n_out = av.shape[0], av.shape[1], bv.shape[1]
            shape, trans = [m, k, n_out], [ta, tb]
            name = ("fused_gemm" if path == "serve" or layer.endswith("fwd")
                    else "fused_gemm_bwd")
            scale, shift = rand(n_out, lo=0.5, hi=1.5), rand(n_out, lo=-0.3,
                                                            hi=0.3)
            nbytes = 4.0 * (m * k + k * n_out + 2 * n_out + m * n_out)
            kern = lambda: mods.fused_gemm(a, b, scale, shift, act, ta, tb)
            plain = lambda: mods.fused_matmul_plain(av, bv, scale, shift, act)
            lib = lambda: torch.matmul(av, bv)
        reps = 20 if path == "serve" else 50
        row = dict(kernel=name, path=path, layer=layer, shape=shape,
                   trans=trans, ms=time_ms(kern, reps=reps),
                   device_us=device_us(kern),
                   **bounds(2.0 * m * k * n_out, nbytes))
        if reference:
            row.update(plain_ms=time_ms(plain, reps=reps),
                       library_ms=time_ms(lib, reps=reps),
                       library_device_us=device_us(lib))
        rows.append(row)
    return rows


def print_rows(rows) -> None:
    for r in rows:
        ref = (f"  plain {r['plain_ms']:.4f}  library {r['library_ms']:.4f} "
               f"ms {r['library_device_us']:.1f} us" if "plain_ms" in r
               else "")
        print(f"  {r['kernel']:14s} {r['path']:5s} {r['layer']:10s} "
              f"{str(r['shape']):24s} trans {str(r['trans']):14s} "
              f"ms {r['ms']:.4f}  device {r['device_us']:.1f} us{ref}  "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']}), f32 "
              f"{r['bound_f32_ms']:.5f} ({r['bound_f32_by']})", flush=True)


def max_err(out, ref, what: str, atol: float = 1e-4,
            rtol: float = 1e-5) -> float:
    import torch

    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"{what}: shape {tuple(out.shape)} vs "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    check(bad == 0, f"{what}: {bad} elements outside {atol:g} + {rtol:g}*|ref| "
          f"(max |err| {float(err.max()):.3g})")
    return float(err.max())


def profile_device(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, device-busy ms, device
    events by start). Device work = kernel and memcpy events on the card;
    busy time is the union of their intervals. CUPTI's "Activity Buffer
    Request" marks the profiler's own buffer handling, not work of the
    program."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in sorted(prof.events(),
                                key=lambda e: e.time_range.start)
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    return wall_ms, busy_us / 1e3, events


def top_ops(events, n: int):
    """(ms, count, name) of the n device operations with the most time."""
    by_name = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    return sorted(((t / 1e3, c, k) for k, (t, c) in by_name.items()),
                  reverse=True)[:n]



def main() -> int:
    import numpy as np
    import torch

    # -- 1. card ------------------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                    PipelineConfig)
    from satae_torch.data.augment import normalize
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.kernels import _build
    from satae_torch.kernels.conv import conv2d_bn_act, conv2d_bn_act_plain
    from satae_torch.kernels.matmul import (fused_gemm, fused_matmul,
                                            fused_matmul_bwd,
                                            fused_matmul_bwd_plain,
                                            fused_matmul_plain, split_k_plan)
    from satae_torch.models.mlp import MLP
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn import layers as L
    from satae_torch.nn.init import init_
    from satae_torch.train import hbm
    from satae_torch.train.extract import extract_chunk
    from satae_torch.train.optim import adam_init
    from satae_torch.train.steps import ae_train_step, mlp_train_step

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({_build.build_dir()})", flush=True)
    ptxas = _build.ptxas_report()
    for r in ptxas:
        print(f"  ptxas {r['kernel']}: {r['registers']} registers, "
              f"{r['smem']} B static shared memory, spills "
              f"{r['spill_stores']} B stored / {r['spill_loads']} B loaded",
              flush=True)
    check(len(ptxas) == 10, f"{len(ptxas)} kernel instantiations in the "
          "ptxas report, expected 10 (K1 8, K2 2)")
    spilled = [r["kernel"] for r in ptxas
               if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"ptxas spills registers in {spilled}")

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
    # ... plus 8192 x 4096 x 64, whose 128 tiles take one split: all of K in
    # one block, the case that holds the per-slice accumulation
    k1_shapes = [(CHUNK, 4096, 64), (CHUNK, 64, 128), (CHUNK, 128, 64),
                 (CHUNK, 64, 10), (64, 4096, 64), (64, 64, 128), (7, 33, 10),
                 (1, 64, 10), (8192, 4096, 64)]
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
    split_err, plans = 0.0, {}
    for m, k, n in SPLIT_SHAPES:
        a = torch.randn(m, k, device=dev, generator=g)
        b = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = affine(n)
        for ta, tb in LAYOUTS:
            a_buf = a.t().contiguous() if ta else a
            b_buf = b.t().contiguous() if tb else b
            for act in ACTS:
                split_err = max(split_err, max_err(
                    fused_gemm(a_buf, b_buf, scale, shift, act, ta, tb),
                    fused_matmul_plain(a, b, scale, shift, act),
                    f"K1 split-K {(m, k, n)} trans_a={ta} trans_b={tb} "
                    f"{act}"))
            first = fused_gemm(a_buf, b_buf, scale, shift, "relu", ta, tb)
            same = all(torch.equal(first, fused_gemm(
                a_buf, b_buf, scale, shift, "relu", ta, tb)) for _ in range(4))
            check(same, f"K1 {(m, k, n)} trans_a={ta} trans_b={tb}: repeated "
                  "calls differ bitwise")
        plans[(m, k, n)] = split_k_plan(m, n, k)
        tile_m, tile_n, splits, per = plans[(m, k, n)]
        tiles = -(-m // tile_m) * -(-n // tile_n)
        print(f"  K1 {(m, k, n)}: plan {tiles} tiles of {tile_m}x{tile_n} x "
              f"{splits} splits of {per} = {tiles * splits} blocks", flush=True)
    k1_err = max(k1_err, split_err)
    try:  # a scale of the wrong length never reaches the kernel
        fused_gemm(a, b, torch.ones(n + 1, device=dev))
        check(False, "fused_gemm took a scale of the wrong length")
    except ValueError:
        pass
    print(f"K1 split-K and ragged K vs plain: {len(SPLIT_SHAPES)} shapes x 4 "
          f"layouts x 3 activations, max |err| {split_err:.3g}; 5 calls per "
          "shape and layout bitwise equal", flush=True)

    # -- 4. K2 --------------------------------------------------------------
    chans = (3, 32, 64, 128, 256)
    k2_path = [(CHUNK, 64 >> i, chans[i], chans[i + 1]) for i in range(4)]
    k2_err = 0.0
    for n, hw, cin, cout in k2_path + [(3, 7, 5, 9), (2, 9, 6, 40),
                                       (3, 11, 8, 72)]:
        x = rand(n, hw, hw, cin)
        w = rand(3, 3, cin, cout, lo=-1.0, hi=1.0) / (9 * cin) ** 0.5
        scale, shift = affine(cout)
        acts = ("relu",) if n == CHUNK else ACTS
        for act in acts:
            k2_err = max(k2_err, max_err(
                conv2d_bn_act(x, w, scale, shift, 2, 1, act),
                conv2d_bn_act_plain(x, w, scale, shift, 2, 1, act),
                f"K2 {(n, hw, hw, cin, cout)} {act}"))
        if (n, cin) == (CHUNK, 32):
            conv1 = x, w, scale, shift
    x, w, scale, shift = conv1
    first = conv2d_bn_act(x, w, scale, shift, 2, 1, "relu")
    check(all(torch.equal(first, conv2d_bn_act(x, w, scale, shift, 2, 1,
                                               "relu")) for _ in range(4)),
          "K2 conv1: repeated calls differ bitwise")
    print(f"K2 conv2d_bn_act vs plain: 13 cases (Cin 3, 5 and 6: 4-byte "
          f"copies; Cout 9, 40, 72: ragged 32/64-wide tiles), max |err| "
          f"{k2_err:.3g}; conv1 5 calls bitwise equal", flush=True)

    # -- 5. time ------------------------------------------------------------
    all_rows = kernel_rows(SimpleNamespace(
        fused_gemm=fused_gemm, fused_matmul_plain=fused_matmul_plain,
        conv2d_bn_act=conv2d_bn_act, conv2d_bn_act_plain=conv2d_bn_act_plain))
    rows = [r for r in all_rows if r["path"] == "serve"]
    train_rows = [r for r in all_rows if r["path"] != "serve"]
    print(f"per launch, serving chunk of {CHUNK} (card {card}):", flush=True)
    print_rows(rows)

    # -- 6. serve -----------------------------------------------------------
    cfg = PipelineConfig(data=DataConfig(per_class=2000,
                                         synthetic_difficulty="hard"))
    t0 = time.perf_counter()
    raw = load_dataset(cfg.data)
    splits = make_splits(raw, cfg.data)
    test = splits.test
    data_s = time.perf_counter() - t0
    pipe = SatAEPipeline(cfg).load(str(CKPT))
    check(pipe.device.type == "cuda", f"pipeline on {pipe.device}")
    n_img = len(test)

    kernels.reset_launch_counts()
    preds = pipe.predict(test.images)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    n_chunks = -(-n_img // CHUNK)
    check(launches == {"fused_gemm": 4 * n_chunks, "fused_gemm_bwd": 0,
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
    with torch.no_grad():  # the modules on stock PyTorch ops, not K1
        x = normalize(torch.from_numpy(test.images).to(dev))
        z_plain = pipe.ae.enc(x, L.linear_plain)
        preds_plain = torch.argmax(pipe.mlp(z_plain, linear=L.linear_plain),
                                   dim=-1).cpu().numpy()
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

    wall_ms, dev_ms, events = profile_device(
        lambda: pipe.predict(test.images))
    layers = {"conv2d_bn_act_kernel": ("conv0", "conv1", "conv2", "conv3"),
              "fused_gemm_kernel": ("proj", "fc0", "fc1", "fc2")}
    seq = {k: [e.time_range.elapsed_us() for e in events if k in e.name]
           for k in layers}
    # each chunk launches conv0..conv3, then proj, fc0, fc1, fc2, in order
    per_layer_us = {lab: sum(seq[k][i::4]) / len(seq[k][i::4])
                    for k, labs in layers.items()
                    for i, lab in enumerate(labs)}
    top = top_ops(events, 20)
    print(f"profile of one predict: wall {wall_ms:.3f} ms, device busy "
          f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - dev_ms / wall_ms):.1f}%", flush=True)
    for t, count, key in top[:8]:
        print(f"  {t:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    print("device us per launch: " + ", ".join(
        f"{k} {v:.1f}" for k, v in per_layer_us.items()), flush=True)

    # -- 7. K1 layouts -------------------------------------------------------
    # the forward product (M, K, N) of each linear layer of a batch-64 train
    # step: AE projection, decoder input, head fc1, fc2; MLP fc1 (fc0 is the
    # head's shape), fc2
    train_fwd = [(BATCH, 4096, 64), (BATCH, 64, 4096), (BATCH, 64, 128),
                 (BATCH, 128, 10), (BATCH, 128, 64), (BATCH, 64, 10)]
    products = [pr for m, k, n in train_fwd
                for pr in ((m, k, n), (m, n, k), (k, m, n))]  # fwd, dX, dW
    products += [(7, 33, 10), (1, 64, 10)]
    layout_err = 0.0
    for m, k, n in products:
        a = torch.randn(m, k, device=dev, generator=g)
        b = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = affine(n)
        ref = fused_matmul_plain(a, b, scale, shift)
        for ta, tb in itertools.product((False, True), repeat=2):
            out = fused_gemm(a.t().contiguous() if ta else a,
                             b.t().contiguous() if tb else b, scale, shift,
                             "none", ta, tb)
            layout_err = max(layout_err, max_err(
                out, ref, f"K1 layout {(m, k, n)} trans_a={ta} "
                f"trans_b={tb}"))
    print(f"K1 layouts vs plain: {4 * len(products)} cases (every "
          "(trans_a, trans_b) at the forward, dX and dW products of a "
          f"batch-{BATCH} train step), max |err| {layout_err:.3g}, tolerance "
          "1e-4 + 1e-5*|ref|", flush=True)

    # -- 8. K1 backward -----------------------------------------------------
    bwd_err, n_bwd = 0.0, 0
    names = ("dx", "dw", "dscale", "dshift")
    for (m, k, n), act in itertools.product(
            train_fwd + [(7, 33, 10), (1, 64, 10)], ACTS):
        x = torch.randn(m, k, device=dev, generator=g)
        w = rand(n, k, lo=-1.0, hi=1.0) / k ** 0.5  # nn.Linear (out, in)
        scale, shift = affine(n)
        pre = fused_matmul_plain(x, w.t(), scale, shift)
        cot = torch.randn(m, n, device=dev, generator=g) * (pre.abs() > 1e-3)
        leaves = [t.clone().requires_grad_() for t in (x, w, scale, shift)]
        y = fused_matmul(*leaves, act, w_nk=True)
        y.backward(cot)
        ref_bwd = fused_matmul_bwd_plain(cot, x, w, scale, y.detach(), act,
                                         w_nk=True)
        plain = [t.clone().requires_grad_() for t in (x, w, scale, shift)]
        y_p = fused_matmul_plain(plain[0], plain[1].t(), *plain[2:], act)
        ref_auto = torch.autograd.grad(y_p, plain, cot)
        for name, leaf, r1, r2 in zip(names, leaves, ref_bwd, ref_auto):
            what = f"K1 backward {name} {(m, k, n)} {act}"
            bwd_err = max(bwd_err, max_err(leaf.grad, r1, what + " vs bwd"),
                          max_err(leaf.grad, r2, what + " vs autograd"))
        n_bwd += 1
    # a linear layer: constant scale -> dx, dw only (no z recompute), dshift
    x, w = (t.requires_grad_() for t in (
        torch.randn(BATCH, 128, device=dev, generator=g),
        rand(10, 128, lo=-1.0, hi=1.0) / 128 ** 0.5))
    bias = rand(10, lo=-0.3, hi=0.3).requires_grad_()
    pre = L.linear_plain(x, w, bias).detach()
    cot = torch.randn(BATCH, 10, device=dev, generator=g) * (pre.abs() > 1e-3)
    before = fused_matmul_bwd.launches
    got = torch.autograd.grad(L.linear(x, w, bias, "relu"), (x, w, bias), cot)
    check(fused_matmul_bwd.launches - before == 2,
          "a linear layer's backward is two K1 launches (dx, dw)")
    ref = torch.autograd.grad(L.linear_plain(x, w, bias, "relu"),
                              (x, w, bias), cot)
    for name, a, r in zip(("dx", "dw", "dbias"), got, ref):
        bwd_err = max(bwd_err, max_err(a, r, f"linear backward {name}"))
    print(f"K1 backward vs fused_matmul_bwd_plain and vs autograd through "
          f"fused_matmul_plain: {n_bwd} cases x 4 gradients, max |err| "
          f"{bwd_err:.3g}, tolerance 1e-4 + 1e-5*|ref|; a linear layer's "
          "backward: 2 launches", flush=True)

    # -- 9. train-step parity -----------------------------------------------
    def pre_bn_biases(model):
        """(bias name, BatchNorm name) of the layers whose bias feeds a
        train-mode BatchNorm: their exact gradient is zero."""
        names_ = {mod: nm for nm, mod in model.named_modules()}
        pairs = (model.hidden() if isinstance(model, MLP) else
                 model.enc.blocks() + [(c, bn) for c, bn in model.dec.blocks()
                                       if bn is not None])
        return [(f"{names_[lay]}.bias", names_[bn]) for lay, bn in pairs]

    def run_steps(model, step, batches, lr, linear):
        """``step`` over ``batches`` from a copy of ``model``: (final state,
        per-step losses, first-step gradients, each BatchNorm's share of the
        biases that feed it, launch counts)."""
        model = copy.deepcopy(model)
        opt = adam_init(list(model.parameters()))
        pairs = pre_bn_biases(model)
        share = {bn: 0.0 for _, bn in pairs}
        losses, first = [], None
        kernels.reset_launch_counts()
        for batch in batches:
            sd = model.state_dict()
            for b_name, bn in pairs:  # BatchNorm momentum 0.1
                share[bn] = 0.9 * share[bn] + 0.1 * sd[b_name]
            metrics, grads = step(model, opt, linear=linear, lr=lr, **batch)
            losses.append(float(metrics["loss"]))
            first = grads if first is None else first
        return (model.state_dict(), losses, first, share,
                kernels.launch_counts())

    def loss_gaps(losses, ref):
        return [abs(a - b) / abs(b) for a, b in zip(losses, ref)]

    def final_state(model, lr, steps, sd_a, share_a, sd_b, share_b):
        """{tensor: (measure, value, bound)} of run a's final state against
        run b's. Parameters: relative L2 per tensor, and running variances
        too; running means, net of the pre-BN biases' share, in units of the
        running std (the shift they make in the eval-mode normalised
        output). Tensors whose every value the steps' updates made -- the
        biases that feed a BatchNorm (zero gradient: rounding noise in
        Adam's sign) and the zero-initialised BatchNorm betas (norm
        ~lr*steps, so one Adam sign flip, 2*lr, is a large share of it) --
        elementwise against 2*lr*steps, the most Adam's steps move them."""
        by_steps = {b_name for b_name, _ in pre_bn_biases(model)} | {
            name for name, prm in model.named_parameters()
            if not bool(prm.detach().any())}
        out_ = {}
        for name, ref in sd_b.items():
            if name.endswith("num_batches_tracked"):
                continue
            got = sd_a[name]
            if name in by_steps:
                out_[name] = ("by_steps", float((got - ref).abs().max()),
                              2 * lr * steps)
            elif name.endswith("running_mean"):
                bn = name.removesuffix(".running_mean")
                if bn in share_a:
                    got, ref = got - share_a[bn], ref - share_b[bn]
                std = torch.sqrt(sd_b[bn + ".running_var"] + 1e-5)
                out_[name] = ("std", float(((got - ref) / std).abs().max()),
                              1e-3)
            else:
                out_[name] = ("rel_l2", float((got - ref).norm())
                              / float(ref.norm()), 1e-3)
        return out_

    def parity(what, model, step, batches, lr, hold=True):
        """The steps on the kernels, with linear_plain, and with linear_plain
        from weights one ulp up (the control: how far float32 rounding
        alone carries the trajectory), all from the same weights; hold the
        kernel run's losses, first-step gradients and final state against
        the plain run's."""
        sd_k, loss_k, grad_k, share_k, k_launch = run_steps(
            model, step, batches, lr, L.linear)
        sd_p, loss_p, grad_p, share_p, p_launch = run_steps(
            model, step, batches, lr, L.linear_plain)
        sd_c, loss_c, _, share_c, _ = run_steps(
            nudged(model), step, batches, lr, L.linear_plain)
        n = len(batches)
        kernel = final_state(model, lr, n, sd_k, share_k, sd_p, share_p)
        control = final_state(model, lr, n, sd_c, share_c, sd_p, share_p)
        gaps_k, gaps_c = loss_gaps(loss_k, loss_p), loss_gaps(loss_c, loss_p)
        grad_err = max(
            float((a - b).abs().max()) for a, b in zip(grad_k, grad_p))
        print(f"{what} parity, {n} steps at lr {lr:g} (kernels | control, "
              "each against the plain run): per-step loss gaps "
              + " ".join(f"{a:.1e}|{b:.1e}" for a, b in zip(gaps_k, gaps_c))
              + f"; first-step gradients max |err| {grad_err:.3g}; final "
              "state, largest against bound:", flush=True)
        for name in sorted(kernel, key=lambda k: -kernel[k][1]
                           / kernel[k][2])[:6]:
            kind, v, b = kernel[name]
            print(f"    {name:28s} {kind:8s} {v:.3g} | {control[name][1]:.3g}"
                  f" (bound {b:g})", flush=True)
        check(set(p_launch.values()) == {0},
              f"{what}: the plain run launched a kernel: {p_launch}")
        result = dict(steps=n, lr=lr, losses_kernel=loss_k,
                      losses_plain=loss_p, losses_control=loss_c,
                      first_grad_max_abs_err=grad_err, final_state=kernel,
                      final_state_control=control, launches=k_launch)
        if not hold:
            return result
        for (nm, _), a, b in zip(model.named_parameters(), grad_k, grad_p):
            max_err(a, b, f"{what}: first-step gradient {nm}", atol=1e-4,
                    rtol=1e-3)
        check(max(gaps_k) <= 1e-3, f"{what}: per-step losses differ by "
              f"{max(gaps_k)} relative")
        bad = {k: v for k, v in kernel.items() if v[1] > v[2]}
        check(not bad, f"{what}: final state outside its bound: {bad}")
        return result

    def nudged(model):
        """A copy with every parameter one float32 ulp up."""
        model = copy.deepcopy(model)
        with torch.no_grad():
            for prm in model.parameters():
                prm.copy_(torch.nextafter(prm, torch.full_like(prm,
                                                               math.inf)))
        return model

    fit_cfg = PipelineConfig(data=cfg.data,
                             ae=AETrainConfig(max_epochs=2),
                             mlp=MLPTrainConfig(epochs=2))
    mcfg, dcfg = fit_cfg.model, fit_cfg.data
    n_lin_ae = 4  # encoder projection, decoder input, head fc1, fc2
    n_lin_mlp = len(mcfg.mlp_hidden) + 1
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                     allow_tf32=False):
        ae = SupervisedAE(mcfg, dcfg.channels, dcfg.image_size)
        init_(ae, torch.Generator().manual_seed(0))
        imgs_tr = torch.from_numpy(splits.train.images).to(dev)
        labs_tr = torch.from_numpy(splits.train.labels).to(dev).long()
        batches = []
        for s_ in range(PARITY_STEPS):
            idx = slice(s_ * BATCH, (s_ + 1) * BATCH)
            batches.append(dict(
                imgs_u8=imgs_tr[idx], labels=labs_tr[idx],
                flip=torch.rand((BATCH, 1), device=dev, generator=g) < 0.5,
                offsets=torch.randint(0, 2 * dcfg.crop_padding + 1,
                                      (BATCH, 2), device=dev, generator=g),
                noise=torch.randn((BATCH, dcfg.image_size, dcfg.image_size,
                                   dcfg.channels), device=dev, generator=g)))
        ae_step = lambda m_, o_, lr, **kw: ae_train_step(
            m_, o_, alpha=35.0, lr=lr, data_cfg=dcfg, **kw)
        ae = ae.to(dev)
        # Held at lr 1e-5, where 10 steps stay in float32's linear regime.
        # At the grid's 1e-4 and the fit's 5e-3 Adam's sign-like first steps
        # carry any rounding difference far: the control run, the plain path
        # from weights one ulp up, moves as far from the plain run as the
        # kernel run does, so those are printed, not held.
        ae_parity = parity("AE", ae, ae_step, batches, 1e-5)
        ae_other_lr = [parity("AE", ae, ae_step, batches, lr, hold=False)
                       for lr in (1e-4, 5e-3)]
        check(ae_parity["launches"] == {
            "fused_gemm": PARITY_STEPS * n_lin_ae,
            "fused_gemm_bwd": PARITY_STEPS * 2 * n_lin_ae,
            "conv2d_bn_act": 0}, f"AE step launches {ae_parity['launches']}")
        mlp = MLP(mcfg)
        init_(mlp, torch.Generator().manual_seed(1))
        batches = [dict(
            x=torch.randn(BATCH, mcfg.latent_dim, device=dev, generator=g),
            labels=torch.randint(0, mcfg.num_classes, (BATCH,), device=dev,
                                 generator=g),
            dropout_mask=torch.rand(BATCH, mcfg.mlp_hidden[0], device=dev,
                                    generator=g) >= mcfg.mlp_dropout)
            for _ in range(PARITY_STEPS)]
        mlp_step = lambda m_, o_, lr, **kw: mlp_train_step(
            m_, o_, lr=lr, weight_decay=fit_cfg.mlp.weight_decay, **kw)
        mlp = mlp.to(dev)
        mlp_parity = parity("MLP", mlp, mlp_step, batches, 1e-5)
        mlp_other_lr = [parity("MLP", mlp, mlp_step, batches, 1e-4,
                               hold=False)]
        check(mlp_parity["launches"] == {
            "fused_gemm": PARITY_STEPS * n_lin_mlp,
            "fused_gemm_bwd": PARITY_STEPS * (2 * n_lin_mlp - 1),
            "conv2d_bn_act": 0}, f"MLP step launches {mlp_parity['launches']}")

    # -- 10. fit ------------------------------------------------------------
    print(f"fit: full width {mcfg.encoder_channels}, latent "
          f"{mcfg.latent_dim}, MLP {mcfg.mlp_hidden}, batch {dcfg.batch_size},"
          f" synthetic-hard per_class {dcfg.per_class}; cut: AE max_epochs "
          f"{fit_cfg.ae.max_epochs} (of {AETrainConfig().max_epochs}), MLP "
          f"epochs {fit_cfg.mlp.epochs} (of {MLPTrainConfig().epochs})",
          flush=True)
    fitted = SatAEPipeline(fit_cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = fitted.fit(raw, grid=False, log=lambda ln: print("  " + ln,
                                                                flush=True))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = kernels.launch_counts()
    hist = fitted.history
    n_tr, n_va, n_te = len(splits.train), len(splits.val), len(splits.test)
    steps = n_tr // dcfg.batch_size
    val_b = -(-n_va // dcfg.batch_size)
    chunks = sum(-(-n // extract_chunk(n, dcfg.batch_size))
                 for n in (n_tr, n_va, n_te))
    ep_ae, ep_mlp = len(hist["ae"]["train_loss"]), len(hist["mlp"]["train_loss"])
    expected = {
        "fused_gemm": (ep_ae * (steps + val_b) * n_lin_ae + chunks
                       + ep_mlp * (steps + val_b) * n_lin_mlp + n_lin_mlp),
        "fused_gemm_bwd": (ep_ae * steps * 2 * n_lin_ae
                           + ep_mlp * steps * (2 * n_lin_mlp - 1)),
        "conv2d_bn_act": chunks * len(mcfg.encoder_channels)}
    print(f"fit: {fit_s:.2f} s, stage_seconds {summary.stage_seconds}; "
          f"{ep_ae} AE + {ep_mlp} MLP epochs of {steps} steps, {val_b} val "
          f"batches, {chunks} extraction chunks; launches {fit_launches}, "
          f"expected {expected}", flush=True)
    check(fit_launches == expected, "fit launch counts differ from the "
          "steps, eval batches and extraction chunks")
    for stage_, h in hist.items():
        vals = [v for series in h.values() for v in series]
        check(all(math.isfinite(v) for v in vals), f"{stage_}: a loss is "
              "not finite")
        check(h["train_loss"][1] < h["train_loss"][0],
              f"{stage_}: mean train loss did not fall: {h['train_loss']}")
    print(f"fit: AE train loss {hist['ae']['train_loss']}, MLP train loss "
          f"{hist['mlp']['train_loss']}, AE best val loss "
          f"{summary.ae_val_loss}, MLP best val acc {summary.mlp_val_acc}, "
          f"test accuracy {summary.test_acc}", flush=True)
    check(summary.test_acc > 1.0 / mcfg.num_classes,
          f"test accuracy {summary.test_acc} is not above chance")
    fit_preds = fitted.predict(test.images)
    fit_pred_acc = float((fit_preds == test.labels).mean())
    check(fit_pred_acc == summary.test_acc, f"predict after fit scores "
          f"{fit_pred_acc}, fit reported {summary.test_acc}")
    t0 = time.perf_counter()
    refit = SatAEPipeline(fit_cfg)
    summary_again = refit.fit(raw, grid=False)
    refit_s = time.perf_counter() - t0
    differ = [k for a, b in ((fitted.ae, refit.ae), (fitted.mlp, refit.mlp))
              for k, v in a.state_dict().items()
              if not torch.equal(v, b.state_dict()[k])]
    print(f"fit again: {refit_s:.2f} s; tensors that differ from the first "
          f"fit: {len(differ)}", flush=True)
    check(not differ, f"a second fit differs in {differ}")
    for f in ("ae_val_loss", "mlp_val_acc", "test_acc"):
        check(getattr(summary_again, f) == getattr(summary, f),
              f"a second fit gives {f} {getattr(summary_again, f)}, the "
              f"first {getattr(summary, f)}")

    # -- 11. training times -------------------------------------------------
    print(f"per launch, batch-{BATCH} train steps (measured in phase 5):",
          flush=True)
    print_rows(train_rows)

    def time_epoch_body(run, n_steps):
        run(2)  # warm-up
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        run(n_steps)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0_) / n_steps * 1e3

    n_time = 50
    ae = SupervisedAE(mcfg, dcfg.channels, dcfg.image_size)
    init_(ae, torch.Generator().manual_seed(0))
    ae.to(dev)
    ae_opt = adam_init(list(ae.parameters()))
    order = hbm.epoch_order(n_tr, BATCH, 0, 0)
    ae_run = lambda n_: hbm.ae_train_epoch(
        ae, ae_opt, imgs_tr, labs_tr, order[:n_], 35.0, 5e-3, dcfg, g)
    # the AE step with cuDNN's default algorithms and with the deterministic
    # ones fit asks for, in turns; then a profile of 5 steps each way
    det_flags = lambda det: cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=det, allow_tf32=False)
    step_ms = {False: [], True: []}
    for det in (False, True, True, False):
        with det_flags(det):
            step_ms[det].append(time_epoch_body(ae_run, n_time))
    ae_step_ms, ae_step_det_ms = (sum(step_ms[d]) / 2 for d in (False, True))
    with det_flags(True):
        det_wall, det_dev, det_events = profile_device(lambda: ae_run(5))
    with det_flags(False):
        tr_wall, tr_dev, tr_events = profile_device(lambda: ae_run(5))
        mlp = MLP(mcfg)
        init_(mlp, torch.Generator().manual_seed(1))
        mlp.to(dev)
        mlp_opt = adam_init(list(mlp.parameters()))
        xs = torch.randn(n_tr, mcfg.latent_dim, device=dev, generator=g)
        mlp_run = lambda n_: hbm.mlp_train_epoch(
            mlp, mlp_opt, xs, labs_tr, order[:n_], 1e-4, 1e-4, g)
        mlp_step_ms = time_epoch_body(mlp_run, n_time)
    tr_top = top_ops(tr_events, 12)
    print(f"train steps (epoch bodies, {n_time} steps of batch {BATCH}, "
          f"TF32 off): AE {ae_step_ms:.3f} ms/step "
          f"({BATCH / ae_step_ms * 1e3:.1f} images/s) with cuDNN's default "
          f"algorithms, {ae_step_det_ms:.3f} ms/step with the deterministic "
          f"ones fit uses (runs in turns: default "
          f"{[round(x, 3) for x in step_ms[False]]}, deterministic "
          f"{[round(x, 3) for x in step_ms[True]]}); MLP "
          f"{mlp_step_ms:.3f} ms/step ({BATCH / mlp_step_ms * 1e3:.1f} "
          f"images/s); card {card}", flush=True)
    print(f"profile of 5 AE steps: wall {tr_wall:.3f} ms, device busy "
          f"{tr_dev:.3f} ms ({100 * tr_dev / tr_wall:.1f}%), idle "
          f"{100 * (1 - tr_dev / tr_wall):.1f}%, {len(tr_events)} device "
          f"events; with the deterministic algorithms: wall {det_wall:.3f} "
          f"ms, device busy {det_dev:.3f} ms, {len(det_events)} device "
          "events", flush=True)
    for t, count, key in tr_top:
        print(f"  {t:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)

    # -- 12. grid -----------------------------------------------------------
    grid = grid_phase(card)
    grid_launches = grid["launches"]

    # -- report -------------------------------------------------------------
    def entry(name, source, replaces, err, rs, per):
        ops_ms = sum(r["bound_ms"] for r in rs
                     if r["bound_by"] == "operations")
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches[name] + fit_launches[name]
                         + grid_launches[name]),
            "launches_by_path": {"serve": launches[name],
                                 "fit": fit_launches[name],
                                 "grid": grid_launches[name]},
            "max_abs_err": err, "tolerance": "1e-4 + 1e-5*|ref|",
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": ("operations" if 2 * ops_ms >= sum(
                r["bound_ms"] for r in rs) else "bytes"),
            "library_ms": sum(r["library_ms"] for r in rs),
            "device_us": sum(r["device_us"] for r in rs),
            "library_device_us": sum(r["library_device_us"] for r in rs),
            "bound_f32_ms": sum(r["bound_f32_ms"] for r in rs),
            "per": f"{per} ({len(rs)} launches)",
        }

    report = {"kernels": [
        entry("fused_gemm", "satae_torch/csrc/fused_gemm.cu",
              "satae/kernels/matmul.py:36", max(k1_err, layout_err),
              [r for r in rows if r["kernel"] == "fused_gemm"],
              f"one {CHUNK}-image serving chunk"),
        entry("fused_gemm_bwd", "satae_torch/csrc/fused_gemm.cu",
              "satae/kernels/matmul.py:100", bwd_err,
              [r for r in train_rows if r["kernel"] == "fused_gemm_bwd"
               and r["path"] == "ae"], f"one batch-{BATCH} AE train step"),
        entry("conv2d_bn_act", "satae_torch/csrc/conv_bn_act.cu",
              "satae/kernels/conv.py:36", k2_err,
              [r for r in rows if r["kernel"] == "conv2d_bn_act"],
              f"one {CHUNK}-image serving chunk")]}
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, build_s=build_s, ptxas=ptxas,
        split_plans={str(k): v for k, v in plans.items()}, rows=rows,
        accuracy=acc, recorded_accuracy=ref_acc, max_dz=dz, agree=agree,
        predict_images_per_s=ips, predict_ms=predict_ms, n_images=n_img,
        data_s=data_s, profile_wall_ms=wall_ms, profile_device_ms=dev_ms,
        profile_top=top[:20], profile_us_per_launch=per_layer_us,
        layout_err=layout_err, bwd_err=bwd_err, ae_parity=ae_parity,
        ae_parity_other_lr=ae_other_lr, mlp_parity=mlp_parity,
        mlp_parity_other_lr=mlp_other_lr, fit_s=fit_s, fit_summary=summary.__dict__,
        fit_history=hist, fit_launches=fit_launches,
        fit_expected_launches=expected, fit_predict_acc=fit_pred_acc,
        refit_s=refit_s,
        train_rows=train_rows, ae_step_ms=ae_step_ms,
        ae_step_det_ms=ae_step_det_ms, ae_step_ms_in_turns=step_ms,
        det_profile_wall_ms=det_wall, det_profile_device_ms=det_dev,
        det_profile_top=top_ops(det_events, 12),
        mlp_step_ms=mlp_step_ms, train_profile_wall_ms=tr_wall,
        train_profile_device_ms=tr_dev, train_profile_top=tr_top, grid=grid,
        **report), indent=1))
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def grid_phase(card: str) -> dict:
    """Phase 12: the grid fit of the recorded cross-framework gate, its
    resume, evaluate, save and export. Returns what chip_smoke.json keeps;
    ``launches`` are the first fit's."""
    import numpy as np
    import torch

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                    PipelineConfig, RuntimeConfig)
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.train.extract import extract_chunk

    gate = json.loads((REPO / "benchmarks" / "torch_parity_pc256" /
                       "torch_pipeline_parity.json").read_text())
    alphas = tuple(gate["ae_grid"]["alphas"])
    ae_lrs = tuple(gate["ae_grid"]["lrs"])
    mlp_lrs = tuple(gate["mlp_lrs"])
    cfg = PipelineConfig(
        data=DataConfig(per_class=gate["per_class"],
                        synthetic_difficulty="hard"),
        ae=AETrainConfig(alphas=alphas, learning_rates=ae_lrs,
                         max_epochs=gate["ae_epochs"],
                         patience=gate["ae_epochs"]),
        mlp=MLPTrainConfig(learning_rates=mlp_lrs,
                           epochs=gate["mlp_epochs"]),
        runtime=RuntimeConfig(seed=gate["seed"]))
    mcfg, bs = cfg.model, cfg.data.batch_size
    raw = load_dataset(cfg.data)
    splits = make_splits(raw, cfg.data)
    test = splits.test
    run = REPO / "chiprun_out" / "grid_run"
    shutil.rmtree(run, ignore_errors=True)
    print(f"grid: channels {mcfg.encoder_channels}, latent {mcfg.latent_dim}"
          f", MLP {mcfg.mlp_hidden}, batch {bs}, synthetic-hard per_class "
          f"{cfg.data.per_class} ({len(splits.train)} / {len(splits.val)} / "
          f"{len(test)}), seed {cfg.runtime.seed}; AE alpha {alphas} x lr "
          f"{ae_lrs}, {cfg.ae.max_epochs} epochs, patience {cfg.ae.patience};"
          f" MLP lrs {mlp_lrs}, {cfg.mlp.epochs} epochs", flush=True)

    def timed_fit(pipe):
        """fit(grid=True, out_dir=run) with each log line's time stamp."""
        lines = []
        log = lambda ln: lines.append((time.perf_counter(), ln))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        summary = pipe.fit(raw, grid=True, out_dir=str(run), log=log)
        torch.cuda.synchronize()
        return summary, time.perf_counter() - t0, t0, lines, \
            kernels.launch_counts()

    pipe = SatAEPipeline(cfg)
    summary, fit_s, t0, lines, launches = timed_fit(pipe)
    for _, ln in lines:
        print("  " + ln, flush=True)

    # seconds per config: from one log line to the next; the first of each
    # sweep from the sweep's start (after the data stage; after extraction)
    st = summary.stage_seconds
    ae_lines = [t for t, ln in lines if ln.startswith("alpha=")]
    mlp_lines = [t for t, ln in lines if ln.startswith("lr=")]
    ae_start = t0 + st["data"]
    mlp_start = ae_start + st["ae"] + st["extract"]
    per_ae = np.diff([ae_start] + ae_lines).tolist()
    per_mlp = np.diff([mlp_start] + mlp_lines).tolist()
    print(f"grid: {fit_s:.2f} s, stage_seconds {st}; seconds per AE config "
          f"{[round(x, 2) for x in per_ae]}, per MLP lr "
          f"{[round(x, 2) for x in per_mlp]}; card {card}", flush=True)

    # the stores: satae's keys (GridResultStore.key: the hparams as JSON,
    # names sorted), strict JSON
    def strict(path):
        return json.loads(path.read_text(), parse_constant=lambda c: check(
            False, f"{path.name}: non-standard JSON constant {c}"))
    ae_store = strict(run / "validation_losses.json")
    mlp_store = strict(run / "mlp_results.json")
    want_ae = [json.dumps({"alpha": a, "lr": lr}) for a in alphas
               for lr in ae_lrs]
    want_mlp = [json.dumps({"lr": lr}) for lr in mlp_lrs]
    check(list(ae_store) == want_ae, f"validation_losses.json keys "
          f"{list(ae_store)}, expected {want_ae}")
    check(list(mlp_store) == want_mlp, f"mlp_results.json keys "
          f"{list(mlp_store)}, expected {want_mlp}")

    # launch counts, derived as for phase 10, per config and lr
    n_tr, n_va, n_te = len(splits.train), len(splits.val), len(test)
    steps, val_b, test_b = n_tr // bs, -(-n_va // bs), -(-n_te // bs)
    chunks = sum(-(-n // extract_chunk(n, bs)) for n in (n_tr, n_va, n_te))
    epochs_ae = [r["epochs_run"] for r in ae_store.values()]
    check(epochs_ae == [cfg.ae.max_epochs] * len(want_ae),
          f"AE epochs run {epochs_ae}: patience {cfg.ae.patience} cannot "
          f"stop {cfg.ae.max_epochs} epochs early")
    n_ae, n_lr, e_mlp = len(want_ae), len(want_mlp), cfg.mlp.epochs
    n_lin_ae, n_lin_mlp = 4, len(mcfg.mlp_hidden) + 1
    expected = {
        "fused_gemm": (n_ae * cfg.ae.max_epochs * (steps + val_b) * n_lin_ae
                       + chunks
                       + n_lr * e_mlp * (steps + val_b) * n_lin_mlp
                       + n_lr * test_b * n_lin_mlp + n_lin_mlp),
        "fused_gemm_bwd": (n_ae * cfg.ae.max_epochs * steps * 2 * n_lin_ae
                           + n_lr * e_mlp * steps * (2 * n_lin_mlp - 1)),
        "conv2d_bn_act": chunks * len(mcfg.encoder_channels)}
    print(f"grid: {n_ae} AE configs x {cfg.ae.max_epochs} epochs and {n_lr} "
          f"MLP lrs x {e_mlp} epochs of {steps} steps, {val_b} val batches, "
          f"{test_b} test batches, {chunks} extraction chunks; launches "
          f"{launches}, expected {expected}", flush=True)
    check(launches == expected, "grid launch counts differ from the configs,"
          " steps, eval batches and extraction chunks")

    # the outcome against satae's recorded run on the same arrays
    rec = gate["satae"]
    acc_gap = abs(summary.test_acc - rec["test_acc"])
    print(f"grid: winners AE {summary.ae_hparams} (satae recorded "
          f"{rec['ae_hparams']}), MLP {summary.mlp_hparams} (recorded "
          f"{rec['mlp_hparams']}); AE best val loss {summary.ae_val_loss} "
          f"(recorded {rec['ae_best_val_loss']}), MLP best val acc "
          f"{summary.mlp_val_acc} (recorded {rec['mlp_best_val_acc']}), test "
          f"accuracy {summary.test_acc} (recorded {rec['test_acc']}, gap "
          f"{acc_gap:.4f}, band {gate['band']}); per-lr test accuracy "
          f"{[r['test_acc'] for r in mlp_store.values()]}", flush=True)
    check(acc_gap <= gate["band"], f"test accuracy {summary.test_acc} is "
          f"{acc_gap:.4f} from satae's {rec['test_acc']}")
    preds = pipe.predict(test.images)
    check(float((preds == test.labels).mean()) == summary.test_acc,
          "predict after the grid fit disagrees with its test accuracy")

    # a second fit on the same run directory trains nothing
    again = SatAEPipeline(cfg)
    summary2, resume_s, _, lines2, launches2 = timed_fit(again)
    expected2 = {"fused_gemm": chunks + n_lin_mlp, "fused_gemm_bwd": 0,
                 "conv2d_bn_act": chunks * len(mcfg.encoder_channels)}
    print(f"grid resume: {resume_s:.2f} s, {len(lines2)} log lines, "
          f"launches {launches2}, expected {expected2}", flush=True)
    check(len(lines2) == n_ae + n_lr
          and all(ln.startswith("skip cached") for _, ln in lines2),
          f"the resumed fit did not skip every config: {lines2}")
    check(launches2 == expected2, "resumed fit launch counts")
    for f in ("ae_hparams", "ae_val_loss", "mlp_hparams", "mlp_val_acc",
              "test_acc"):
        check(getattr(summary2, f) == getattr(summary, f),
              f"resumed {f} {getattr(summary2, f)} != {getattr(summary, f)}")
    check(np.array_equal(again.predict(test.images), preds),
          "the resumed pipeline predicts differently")

    # load + evaluate, save + load, export + load_torch
    loaded = SatAEPipeline(cfg).load(str(run))
    ev = loaded.evaluate(test)
    recorded = json.loads((run / "fit_summary.json").read_text())["test_acc"]
    check(float(ev["accuracy"]) == recorded, f"evaluate after load scores "
          f"{ev['accuracy']}, fit_summary.json {recorded}")
    loaded.save(str(run / "saved"))
    check(np.array_equal(SatAEPipeline(cfg).load(str(run / "saved")).predict(
        test.images), preds), "save + load predicts differently")
    loaded.export_torch(str(run / "pt"))
    check(np.array_equal(SatAEPipeline(cfg).load_torch(
        str(run / "pt" / "AE_GLOBAL_BEST.pt"),
        str(run / "pt" / "MLP_GLOBAL_BEST.pt")).predict(test.images), preds),
        "export_torch + load_torch predicts differently")
    print(f"grid: load + evaluate accuracy {float(ev['accuracy']):.6f} = "
          "fit_summary.json; save + load and export_torch + load_torch "
          "predict the same", flush=True)
    print(ev["report"], flush=True)
    shutil.rmtree(run)
    return dict(config=dict(per_class=cfg.data.per_class, alphas=alphas,
                            ae_lrs=ae_lrs, ae_epochs=cfg.ae.max_epochs,
                            mlp_lrs=mlp_lrs, mlp_epochs=e_mlp,
                            seed=cfg.runtime.seed),
                fit_s=fit_s, stage_seconds=st, seconds_per_ae_config=per_ae,
                seconds_per_mlp_lr=per_mlp, launches=launches,
                expected_launches=expected, summary=summary.__dict__,
                ae_results=ae_store, mlp_results=mlp_store,
                recorded=rec, test_acc_gap=acc_gap, resume_s=resume_s,
                resume_launches=launches2,
                resume_stage_seconds=summary2.stage_seconds,
                evaluate_accuracy=float(ev["accuracy"]),
                confusion_matrix=ev["confusion_matrix"].tolist(), card=card)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_times_main(root: str) -> int:
    """The --ab child: :func:`kernel_rows` on the kernels of the satae_torch
    under ``root``, as one JSON line."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    root_ = Path(root).resolve()
    sys.path.insert(0, str(root_))
    import satae_torch
    from satae_torch.kernels import conv, matmul

    pkg = Path(satae_torch.__file__).resolve()
    check(pkg.is_relative_to(root_), f"satae_torch came from {pkg}, not "
          f"from {root_}")
    rows = kernel_rows(SimpleNamespace(fused_gemm=matmul.fused_gemm,
                                       conv2d_bn_act=conv.conv2d_bn_act),
                       reference=False)
    print(json.dumps(rows), flush=True)
    return 0


def ab_main(parent: str) -> int:
    """Every K1 and K2 launch timed in the tree at ``parent`` and in this
    one, in turns parent, this, this, parent, one process each."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    check((Path(parent) / "satae_torch").is_dir(),
          f"{parent} holds no satae_torch")
    card = card_line()
    print(card, flush=True)
    runs = []
    for label, root in (("parent", parent), ("change", REPO),
                        ("change", REPO), ("parent", parent)):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kernel-times",
             str(root)], capture_output=True, text=True, timeout=900)
        check(res.returncode == 0, f"kernel times in {root} failed:\n"
              f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        runs.append(dict(label=label, root=str(root),
                         seconds=time.perf_counter() - t0,
                         rows=json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"{label} ({root}): {runs[-1]['seconds']:.1f} s", flush=True)
    print("device us per launch: parent (1st, 4th run) | change (2nd, 3rd) "
          "| change / parent; back-to-back ms the same way", flush=True)
    for i, r in enumerate(runs[0]["rows"]):
        par = [runs[j]["rows"][i] for j in (0, 3)]
        chg = [runs[j]["rows"][i] for j in (1, 2)]
        us_p = sum(x["device_us"] for x in par) / 2
        us_c = sum(x["device_us"] for x in chg) / 2
        print(f"  {r['kernel']:14s} {r['path']:5s} {r['layer']:10s} "
              f"{str(r['shape']):24s} us {par[0]['device_us']:.1f} "
              f"{par[1]['device_us']:.1f} | {chg[0]['device_us']:.1f} "
              f"{chg[1]['device_us']:.1f} | {us_c / us_p:.3f};  ms "
              f"{par[0]['ms']:.4f} {par[1]['ms']:.4f} | {chg[0]['ms']:.4f} "
              f"{chg[1]['ms']:.4f}", flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab.json").write_text(json.dumps(dict(card=card, runs=runs),
                                            indent=1))
    return 0


def split_sweep_main() -> int:
    """K1's device us per launch at the long-K products for each split count
    and tile width, launched with that plan directly."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    from satae_torch.kernels import _build
    from satae_torch.kernels.matmul import BK, _tile_counters, split_k_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    lib = _build.load("fused_gemm")
    counters = _tile_counters(dev)
    rows = []
    for m, k, n, tb in ((CHUNK, 4096, 64, False), (BATCH, 4096, 64, True)):
        a = torch.randn(m, k, device=dev, generator=g)
        b = (torch.rand(*((n, k) if tb else (k, n)), device=dev, generator=g)
             * 2 - 1) / k ** 0.5
        bv = b.t() if tb else b
        ref = torch.matmul(a, bv)
        lib_us = device_us(lambda: torch.matmul(a, bv), 50)
        print(f"K1 {(m, k, n)} trans_b={tb}: plan {split_k_plan(m, n, k)}, "
              f"torch.matmul {lib_us:.1f} us", flush=True)
        for tile_n in (32, 64):
            for want in (1, 2, 4, 8, 16, 32, 64):
                kps = -(-(-(-k // want)) // BK) * BK
                splits = -(-k // kps)
                out = torch.empty(m, n, device=dev)
                ws = torch.empty(splits * m * n, device=dev)
                run = lambda: _build.launch(
                    lib, "satae_fused_gemm", dev, a.data_ptr(), b.data_ptr(),
                    0, 0, out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                    m, n, k, 0, 0, int(tb), tile_n, splits, kps)
                run()
                err = max_err(out, ref, f"K1 {(m, k, n)} tile_n {tile_n} "
                              f"{splits} splits")
                us = device_us(run, 50)
                rows.append(dict(shape=[m, k, n], trans_b=tb, tile_n=tile_n,
                                 splits=splits, k_per_split=kps,
                                 device_us=us, max_abs_err=err,
                                 library_device_us=lib_us))
                print(f"  tile 64x{tile_n}, {splits:2d} splits of {kps:4d}: "
                      f"{us:7.1f} us  max |err| {err:.3g}", flush=True)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "split_sweep.json").write_text(json.dumps(
        dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--split-sweep"]:
        sys.exit(split_sweep_main())
    if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 3:
        sys.exit(kernel_times_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        sys.exit(ab_main(sys.argv[2]))
    if len(sys.argv) > 1:
        raise SystemExit(f"usage: {sys.argv[0]} [--ab PARENT_DIR | "
                         "--split-sweep]")
    sys.exit(main())
