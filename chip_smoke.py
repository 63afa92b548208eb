#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (satae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the smoke run, phases 1-29
    python3 chip_smoke.py --ab PARENT_DIR  # A/B of the kernels' times
    python3 chip_smoke.py --split-sweep    # K1's time for each split count
    python3 chip_smoke.py --vmap           # the build and phases 21-24 alone
    python3 chip_smoke.py --parallel       # build, phases 10 and 12, 25-28
    python3 chip_smoke.py --example        # the build and phase 29 alone
    python3 chip_smoke.py --vit            # the build and phase 30 alone

Phases, in order; any failure exits non-zero:

1. card   -- requires a CUDA device; prints nvidia-smi's name and power limit.
2. build  -- compiles the hand-written kernels from satae_torch/csrc with nvcc
             (sm_90a) and prints the build seconds and the ptxas report
             (registers, shared memory, spills per instantiation); fails on
             any spill, unless every kernel of satae::hopper, float32
             (3xTF32) and bf16, has HGMMA (wgmma) in its SASS (cuobjdump
             -sass) -- K1's fused_gemm_tma_kernel, which takes the config
             count C, among them -- and on any ptxas note of serialised
             wgmmas.
3. K1     -- fused_gemm against fused_matmul_plain (TF32 off) at every K1
             shape of the serving path plus the awkward shapes of the JAX
             package's kernel tests, 8192x4096x64 (one split, all of K in
             one block) and the decoder's and calibration's products (their
             plans printed), all three activations; then the split-K
             and ragged-K shapes (SPLIT_SHAPES) in every (trans_a, trans_b)
             layout and activation, with each shape's route and plan
             printed, and repeated calls held bitwise equal; each launch's
             route held to the rule (f32_route: the wgmma kernel where every
             buffer's base and rows are 16-byte aligned, else the mma.sync
             loop); a scale of the wrong length is refused.
4. K2     -- conv2d_bn_act against conv2d_bn_act_plain at the four encoder
             layers of a 512-image chunk with the fold's K-major weights
             (conv0 on the staged-rows kernel, conv1-3 on TMA im2col, held),
             non-trivial BatchNorm, plus small convs with Cin % 4 != 0
             (4-byte copies) and ragged 32/64-wide tiles on the mma.sync
             loop; repeated calls at conv1 held bitwise equal, and conv1
             from a contiguous HWIO weight bitwise the K-major one's.
             Tolerance for K1 and K2: |err| <= 1e-4 + 1e-5 * |ref|.
5. time   -- every K1 and K2 launch of a serving chunk, and the decoder's
             and calibration's K1 launches: back-to-back ms (CUDA events)
             and device us per launch (CUDA events around calls queued
             behind a spin kernel, see device_us: a reading below its bound
             fails the run) of the kernel and of the one-call library
             equivalent, the plain version's ms, and two bounds, the larger
             of bytes at 3.35 TB/s and operations at 165 TFLOP/s (3xTF32 on
             tensor cores: 495 / 3) or at 67 TFLOP/s (float32 on CUDA
             cores), H100 SXM data sheet.
6. serve  -- loads the committed full-width checkpoint
             benchmarks/full_run_hard_f32 through SatAEPipeline, rebuilds the
             synthetic-hard test split with the port's data modules, and runs
             predict on the card with the kernel launch counts zeroed before
             and read after. Test accuracy must be within 0.002 of the run's
             fit_summary.json; latents and predictions are held against the
             plain PyTorch modules on the same card (TF32 off). Then times
             predict (images/s) and profiles one predict call (device us
             per layer: K2 on conv_rows_kernel / conv_im2col_tma_kernel, K1
             on fused_gemm_tma_kernel).
7. layouts -- fused_gemm (K1) with each (trans_a, trans_b) against
             fused_matmul_plain on the same operands, at every product of a
             batch-64 training step (forward, dX, dW of each linear layer)
             plus 7x33x10 and 1x64x10, each launch's route held to
             f32_route (the wgmma kernel for every buffer pair TMA reads);
             tolerance as in 3.
8. bwd    -- K1's autograd function (nn.Linear weight layout) on the card:
             dx, dw, dscale, dshift against fused_matmul_bwd_plain and against
             autograd through fused_matmul_plain, three activations, scale
             requiring a gradient (the z recompute); then the linear layer's
             case, a constant scale: two backward launches, no dscale.
             Every batch-64 launch on the wgmma route but fc2's dX and dW
             (40-byte cotangent rows).
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
13. bf16 kernels -- the bf16 instantiations of K1 (forward and backward)
             and K2 against their plain versions on the same card: the
             serving projection, every K1 launch of a batch-64 AE step in
             its layout, small, odd-K, odd-N and odd-offset products (the
             2-byte copies) in every layout, SPLIT_SHAPES and
             TMA_EDGE_SHAPES in every layout and activation, the backward
             against fused_matmul_bwd_plain, K2 at the four encoder layers
             of a 512-image chunk and at Cin 3, 5, 6, 8, 16, 64, 128 and
             Cout 9, 16, 24, 40, 64, 72, each case's route printed (K1: the
             wgmma/TMA loader or the cp.async mma.sync loop; K2: staged
             rows, TMA im2col, or mma.sync). Within one
             bf16 ulp of the reference + 1e-6 and >= 99 % bit-equal;
             repeated calls bitwise equal; every main-path bf16 launch on
             wgmma but the head's backward (20-byte rows, no TMA). Then
             every bf16 launch of the main paths timed as in 5, beside bf16
             cuBLAS / cuDNN and the bf16 bounds (2 bytes an element, 989
             TFLOP/s).
14. bf16 serve -- benchmarks/full_run_hard_bf16 served with compute_dtype
             "bfloat16": launches per dtype (K2 4 and K1 1 in bf16, K1 3 in
             float32 per chunk), accuracy within 0.004 of satae's own bf16
             serving (2,649 / 2,990), the same fold on the plain kernel
             versions (latents within 2^-7 relative L2, predictions equal on
             >= 99.9 %) and the plain modules in bf16 (>= 99 %); images/s.
15. bf16 fit -- phase 10's fit in bf16, run twice (bit for bit), and under
             throughput_config (batch 1024); exact launches per dtype,
             float32 master state; then the AE and MLP steps at batch 1024,
             bf16 and float32 in turns.
16. bf16 grid -- phase 12 in bf16 into chiprun_out/grid_run_bf16: exact
             launches per dtype; satae's winners and test accuracy within
             the gate's band (0.03) of satae's own bf16 grid fit of the same
             gate (scripts/satae_pc256_gate_bfloat16.json, from
             scripts/satae_gate_reference.py on a CPU), the gap to satae's
             recorded float32 0.7947 printed beside; resume, evaluate, save
             and export.

Phases 17-20 run with PyTorch's default TF32 flags, as a user's process has
them (phases 3-16 turn TF32 off for the plain references); the entry points
turn it off for their convolutions themselves.

17. decode -- benchmarks/full_run_hard_f32 and full_run_hard_bf16
             reconstruct the test split through reconstruct_batched: exact
             launches (K2 4 and K1 2 per chunk of 512 in the compute dtype;
             decode alone K1 1),
             decode(encode(x)) bitwise equal to reconstruct(x), both
             called again on the same inputs and held bitwise equal to the
             first calls,
             x_hat against the
             plain modules on the card (TF32 off) within RECON_ATOL, the
             mean reconstruction MSE within RECON_MSE_RTOL of satae's on
             the CPU (scripts/satae_serving_reference.json), images/s.
18. calibrate -- satae's CLI calibration: latent 128, 1,000 inits, the
             first shuffled batch of 64 of the synthetic-hard train split
             (per_class 2000), seed 0; K1 launches exactly 4 per init; the
             wall time. Held three ways: CAL_CARRIED inits and the augmented
             batch made on the CPU give on the card the ratios the plain
             versions give on the CPU, within 1e-5 relative (the CPU test
             holds those to satae's); the card's 1,000 inits on that CPU
             batch give the median, p5 and p95 of the port's CPU run on it
             within 3*sqrt(2) of satae's bootstrap standard errors; and the
             card's own run within calibrate_band of satae's CPU run.
             init_ratio of one init, twice on the card: bitwise equal.
19. inflight -- fit(grid=False, out_dir=chiprun_out/inflight_run,
             checkpoint_every=1) at full width, AE 4 epochs and MLP 2, on
             synthetic-hard per_class 256, in a process of its own, killed
             with SIGKILL once its in-flight state records epoch >= 1, then
             run again: the rerun logs "resumed from", launches K1's
             backward only for the AE epochs after the resume (the counts
             derived as in 10), ends with a FitSummary equal to an
             uninterrupted run's bit for bit, and leaves inflight/ empty.
20. cli   -- satae_torch.cli.main in this process: fit (1 + 1 epochs,
             per_class 256, --ckpt-every 1), calibrate --n-inits 50,
             extract, export-torch, each with satae's artifacts and its
             launches; prints which subcommands are not run here (they
             draw figures or decode image files) and whether matplotlib,
             PIL, libjpeg's headers and the native loader are present.

Phases 21-24 turn TF32 off again (their plain references are full float32).

21. batched K1 -- the batched entries of K1 (satae_fused_gemm_batched,
             _batched_bf16_tma and _batched_bf16) at every launch of a
             stacked AE step (C = 45: the projection, the decoder input and
             the head, forward, dX and dW) and of a stacked MLP step (C =
             11) against the plain version per config on the card: float32
             within 1e-4 + 1e-5*|ref|, bf16 within one ulp + 1e-6 and >= 99
             % bit-equal; three launches bitwise equal; each launch's route
             printed and held: every launch, float32 and bf16, on the
             wgmma kernel but fc2's dX and dW (10-wide cotangent rows, the
             mma.sync loop); every config's slice bit-equal to the
             unbatched K1 launched on it wherever the unbatched call takes
             the batched plan on the same route. Device us per launch
             beside C unbatched launches of the same work, torch.bmm (TF32
             off) and the launch's bound.
22. stacked steps -- 10 stacked AE steps at full width, batch 64, C = 45
             (the default grid's alphas, lr 1e-5) and 10 stacked MLP steps
             (C = 11), draws fixed, against each config's single-config
             steps on stock PyTorch linears, held as phase 9 holds its runs;
             exactly 4 + 8 (AE) and 3 + 5 (MLP) batched K1 launches a step;
             the stacked AE step's ms in turns with the 45 single-config
             steps, its device-busy share and peak memory; then the stacked
             AE step in bf16 in turns with float32, and the batched K1's
             device share of each (phase 21's device us of the step's 12
             launches over the step's ms), printed only.
23. vmap grid -- the pc256 gate of phase 12 with parallel_configs=True
             into chiprun_out/vmap_grid_run, in float32 (satae's vmap
             winners, test accuracy within the gate's band of satae's own
             vmap grid, scripts/satae_pc256_gate_vmap_float32.json from
             scripts/satae_gate_reference_vmap.py on a CPU) and in bf16
             (finite, falling losses, float32 master state, accuracy above
             chance, the gap printed), exact launches per dtype derived from
             the stacked steps and eval batches; one epoch of the full
             45-config AE sweep (wall, ms per stacked step, peak memory);
             the CLI's fit --grid --parallel at 1 + 1 epochs with satae's
             artifacts and exact launches.
24. steps engine -- ae_grid_search(engine="steps") for 2 configs x 2
             epochs and mlp_grid_search(engine="steps") for 2 lrs x 2 epochs
             on the gate: exact K1 launches counting the remainder batch (28
             steps an epoch) and 6 unpadded val batches, satae's store keys,
             finite and falling losses.

After phase 15 it prints the model-FLOPs utilization of phase 11's batch-64
AE steps and phase 15's batch-1024 steps (satae_torch.utils.roofline).

Phases 25-28 drive the multi-device runtime (satae_torch.parallel), one
process per rank: a world of one rank is a group this process makes over
NCCL; two ranks on the one card run over Gloo (NCCL puts no two ranks on
one device), each a process of its own (PARALLEL_CHILD).

25. DP fit -- phase 10's fit with n_devices 1: the data-parallel trainer,
             extraction and serving with their collectives; launches and
             summary and curves equal to phase 10's, bit for bit.
26. two ranks -- 10 DP AE steps at lr 1e-5 on two Gloo ranks (32 rows each
             of batches of 64) against one rank on the whole batches, the
             same init and global augmentation draws: held to phase 9's
             bounds, BatchNorm running stats after one step within 1e-5, the
             ranks' states bitwise equal; the weighted eval of 1,001 val
             images: counts equal, sums within 1e-5 relative.
27. sharded grid -- the pc256 gate through the config-sharded sweeps, at
             world size 1 (fit(grid=True), n_devices 1) and on two Gloo ranks
             (the sweeps directly, each rank into its own run directory):
             every config's result phase 12's bit for bit, satae's winners,
             the stores and checkpoints the same bytes from every rank;
             wall times.
28. sharded serving -- full_run_hard_f32 predicted, encoded, decoded and
             reconstructed with n_devices 1 beside the plain pipeline: the
             same launches, predictions equal on >= 99.9 %, accuracy within
             0.002 of the recorded, latents within 1e-3, decoded and
             reconstructed images bitwise the plain pipeline's;
             then torch.distributed.run --standalone --nproc-per-node 1 of
             satae_torch.cli fit --grid --multihost --n-devices 1 (per_class
             12, 1 + 1 epochs): satae's artifacts, K1 and K2 launches.

Phase 29 runs with PyTorch's default TF32 flags, as a user's run would.

29. example -- examples/reproduce_reference_torch.py --quick
             --synthetic-difficulty hard, its main() in this process (the
             notebook's flow: ingest, 50-init calibration, the 2 x 2 AE
             grid for 15 epochs and 2 MLP lrs for 12, evaluation,
             reconstruction and latents; each figure written, or skipped
             with a line naming it where matplotlib is absent), launch
             counts zeroed before and read after: final.json with satae's
             example's keys, finite losses, K1, K1's backward and K2
             launched, test accuracy within EXAMPLE_BAND (0.05) of satae's
             run of its own example on a CPU
             (scripts/satae_example_quick_hard.json, from
             scripts/satae_example_reference.py); winners, calibration
             median and stage seconds printed beside satae's.

The second-to-last line holds the kernels' numbers as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

After phases 5 and 20 the profiler's capture is checked (profiler_check):
sessions of one K1 launch as they open, after 50 ms of idle time, and after
a spin kernel and that idle time, counting the sessions that lost device
records, with the lead of the first record on the profiler's time line.

``--ab PARENT_DIR`` times every K1 and K2 launch of phases 5, 11 and 13, and
every batched K1 launch of phase 21, that both trees have (ms and device us
per launch) in the tree at PARENT_DIR (another checkout of this repository,
with its own satae_torch) and in this one, in turns: parent, this, this,
parent, each in a process of its own that builds that tree's kernels. The
float32 outputs at the shapes of phases 3 and 4, the float32 batched
outputs at phase 21's, and every timed float32 launch's output must be
bitwise equal in all four runs (the float32 wgmma kernels sum as the
mma.sync loop does on the same split plan); for every launch it prints the
share of its outputs bitwise equal to the parent's beside both trees'
device us and this tree's route, and holds that share at 1 and the route
off K1's wide kernel (none of these launches is the ViT's); and it times
each tree's own float32 predict of the committed model in turns. It prints
one line per launch and writes chiprun_out/ab.json.

``--split-sweep`` times K1 at the long-K products (the serving projection
512x4096x64 and the training one, 64x4096x64 with an (N, K) weight) for 1 to
64 splits on 32- and 64-wide tiles on the float32 mma.sync loop, and on the
wgmma route, float32 and bf16, for clusters of 1 to 16 splits; then the
vmap path's two long-K launches at C = 45 (the projection forward and the
decoder input's dX) on the batched wgmma route, float32 and bf16, for every
cluster size of 1 to 16 that whole stages give, beside the batched mma.sync
launch and torch.bmm; each plan held against its plain version (float32
within the tolerance above, bf16 within phase 13's bound), beside the plans
split_k_plan and split_k_plan_tma pick: the measurement the plans rest on.
It writes chiprun_out/split_sweep.json.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent
CKPT = REPO / "benchmarks" / "full_run_hard_f32"
CKPT_BF16 = REPO / "benchmarks" / "full_run_hard_bf16"
# satae's own bf16 serving of CKPT_BF16 on the 2,990-image test split
# (its XLA path on a CPU: 2,649 right); fit_summary.json's 0.885284 was
# scored on a TPU
SATAE_BF16_ACC = 2649 / 2990
# what phases 10 and 12 gave on the H100 before the bf16 instantiations
# existed (PERF.md §6): a fit repeats bit for bit and the float32 kernels
# kept their arithmetic, so they give these again
RECORDED_FIT_AE_VAL_LOSS = 1.9652304556856188
RECORDED_GRID_TEST_ACC = 0.7894736842105263
# satae's bf16 grid fit of the pc256 gate on a CPU, phase 16's reference
# (scripts/satae_gate_reference.py writes it)
SATAE_GATE_BF16 = REPO / "scripts" / "satae_pc256_gate_bfloat16.json"
F32_PEAK = 67e12  # FLOP/s, H100 SXM, CUDA cores, dense
TF32X3_PEAK = 495e12 / 3  # FLOP/s: 3xTF32, three TF32 products per product
BF16_PEAK = 989e12  # FLOP/s, H100 SXM, bf16 on tensor cores, dense
HBM_PEAK = 3.35e12  # bytes/s, H100 SXM
ACTS = ("none", "relu", "sigmoid")
CHUNK = 512
BATCH = 64  # the training batch of the default DataConfig
PARITY_STEPS = 10
# K1 shapes that split K (split_k_plan), with ragged M, N and K
SPLIT_SHAPES = ((CHUNK, 4096, 64), (BATCH, 4096, 64), (BATCH, 4095, 64),
                (100, 4100, 70), (33, 1000, 10))
LAYOUTS = tuple(itertools.product((False, True), repeat=2))
# phase 13's edges of the bf16 wgmma route (every buffer TMA-readable in at
# least one layout): ragged M and N against the 64 x 64 boxes, K ending
# inside a stage, clusters of 11, 3 and 1 splits (SPLIT_SHAPES add 16, 13
# and 8), a single row
TMA_EDGE_SHAPES = ((130, 4160, 72), (200, 1000, 24), (1, 64, 8),
                   (65, 192, 136))
# phase 18: the inits carried from the CPU to the card, and the relative
# bound on their ratios (tests/test_torch_port_calibrate.py's)
CAL_CARRIED, CAL_RTOL = 8, 1e-5
# satae's CPU values that phases 17 and 18 are held against
# (scripts/satae_serving_reference.py writes them)
SATAE_SERVING_REF = REPO / "scripts" / "satae_serving_reference.json"
# phase 17: the mean reconstruction MSE against satae's, relative: the CPU
# test's bound (tests/test_torch_port_decode.py, PERF.md section 2)
RECON_MSE_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# phase 17: x_hat of the kernel path against the plain modules on the card,
# max |diff| and relative L2 (bf16: the fold and K1's single rounding
# against BatchNorm and two roundings per linear in bf16, which a sigmoid
# near 0.5 carries to 2^-4 at single pixels on the CPU)
RECON_ATOL = {"float32": 1e-3, "bfloat16": 2.0 ** -3}
RECON_REL_L2 = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# phase 29: satae's run of its example, --quick --synthetic-difficulty hard,
# on a CPU (scripts/satae_example_reference.py writes it); the band on the
# test accuracy (about 7 of its 141 test images); final.json's keys
SATAE_EXAMPLE_REF = REPO / "scripts" / "satae_example_quick_hard.json"
EXAMPLE_BAND = 0.05
EXAMPLE_KEYS = ["test_accuracy", "ae", "mlp", "calibration_median",
                "timings_s"]
EXAMPLE_FIGURES = ("class_distribution.png", "samples.png",
                   "ratio_histogram.png", "gridsearch_heatmap.png",
                   "confusion_matrix.png", "reconstruction_grid.png",
                   "latent_space_test.png")
# phase 3's K1 shapes: the serving path at chunk 512 (projection, fc0, fc1
# with BN folded, fc2), the JAX package's awkward ones, 8192 x 4096 x 64,
# whose 128 tiles take one split: all of K in one block, the case that holds
# the per-slice accumulation, and the decoder's input at chunk 512 and
# calibration's latent-128 projection and decoder input
K1_SHAPES = ((CHUNK, 4096, 64), (CHUNK, 64, 128), (CHUNK, 128, 64),
             (CHUNK, 64, 10), (64, 4096, 64), (64, 64, 128), (7, 33, 10),
             (1, 64, 10), (8192, 4096, 64), (CHUNK, 64, 4096),
             (BATCH, 4096, 128), (BATCH, 128, 4096))
# phase 4's K2 shapes (n, hw, cin, cout): the four encoder layers of a
# 512-image chunk, then Cin % 4 != 0 and ragged 32/64-wide tiles
K2_SHAPES = tuple((CHUNK, 64 >> i, c, c2) for i, (c, c2) in enumerate(
    zip((3, 32, 64, 128), (32, 64, 128, 256)))) + (
        (3, 7, 5, 9), (2, 9, 6, 40), (3, 11, 8, 72))


# the kernel instantiations of a build (ptxas report: K1 16 mma.sync + 9
# wgmma, which the batched entries launch too, one of them the bf16 GELU
# epilogue's, and the wide kernel's 4, one per activation; K2 4 mma.sync + 5
# wgmma; the ViT encoder's attention and LayerNorm, one each) and those of
# them on wgmma (fused_gemm_tma_kernel x 4 layouts x float32 and bf16,
# fused_gemm_wide_kernel x 4, conv_im2col_tma_kernel: bf16 x 2 N
# tiles and float32, conv_rows_kernel in float32 and bf16)
N_INSTANTIATIONS = 40
N_WGMMA = 18


def hgmma_counts() -> dict:
    """{kernel: HGMMA instructions in its SASS} for every kernel of the
    build in namespace satae::hopper (cuobjdump -sass of the libraries)."""
    from satae_torch.kernels import _build

    tool = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    counts = {}
    for name, lib in _build.build_all().items():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        fn = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[1].strip()
                fn = fn if "hopper" in fn else None
                if fn:
                    counts[fn] = 0
            elif fn and "HGMMA" in ln:
                counts[fn] += 1
    return counts


def wgmma_serialised() -> list:
    """ptxas's notes that it serialised a kernel's wgmmas (C7510-C7520:
    accumulator registers read in flight, divergent paths), from the build
    logs."""
    from satae_torch.kernels import _build

    notes = []
    for name in _build.SOURCES:
        log = _build.build_dir() / f"{name}.log"
        notes += [ln.strip() for ln in log.read_text().splitlines()
                  if "wgmma.mma_async instructions are serialized" in ln]
    return notes


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def counts(**given) -> dict:
    """Launch counts as satae_torch.kernels.launch_counts() gives them, with
    every kernel and dtype not in ``given`` at 0."""
    names = ("fused_gemm", "fused_gemm_bwd", "conv2d_bn_act",
             "fused_gemm_batched", "fused_gemm_batched_bwd", "attention",
             "layer_norm", "fused_gemm_wide")
    out = {n + s: 0 for s in ("", "_bf16") for n in names}
    check(set(given) <= set(out), f"unknown kernel names {set(given)}")
    out.update(given)
    return out


def fit_launches(n_split, bs: int, ep_ae: int, ep_mlp: int, mcfg,
                 bf16: bool, n_lr: int = 1, test_b: int = 0) -> dict:
    """The launches of a fit: ``ep_ae`` AE epochs (summed over its configs)
    and ``ep_mlp`` MLP epochs (over its lrs) of n_train // bs steps and
    ceil(n_val / bs) eval batches each; extraction of the three splits in
    extract_chunk chunks; ``n_lr`` MLP sweeps scoring ``test_b`` test
    batches each; the winner's final test evaluation. A linear layer is one
    K1 launch forward and two backward (the MLP's first layer one: its input
    needs no gradient); an extraction chunk one K2 launch per encoder layer
    and one K1 launch. The AE's launches and extraction run in bf16 under
    the bf16 recipe, the MLP's always in float32."""
    from satae_torch.train.extract import extract_chunk

    n_tr, n_va, n_te = n_split
    steps, val_b = n_tr // bs, -(-n_va // bs)
    chunks = sum(-(-n // extract_chunk(n, bs)) for n in (n_tr, n_va, n_te))
    n_lin_ae, n_lin_mlp = 4, len(mcfg.mlp_hidden) + 1
    s = "_bf16" if bf16 else ""
    out = counts(
        fused_gemm=(ep_mlp * (steps + val_b) * n_lin_mlp
                    + n_lr * test_b * n_lin_mlp + n_lin_mlp),
        fused_gemm_bwd=ep_mlp * steps * (2 * n_lin_mlp - 1))
    out["fused_gemm" + s] += ep_ae * (steps + val_b) * n_lin_ae + chunks
    out["fused_gemm_bwd" + s] += ep_ae * steps * 2 * n_lin_ae
    out["conv2d_bn_act" + s] += chunks * len(mcfg.encoder_channels)
    return out


def pre_bn_biases(model):
    """(bias name, BatchNorm name) of the layers whose bias feeds a
    train-mode BatchNorm: their exact gradient is zero."""
    from satae_torch.models.mlp import MLP

    names_ = {mod: nm for nm, mod in model.named_modules()}
    pairs = (model.hidden() if isinstance(model, MLP) else
             model.enc.blocks() + [(c, bn) for c, bn in model.dec.blocks()
                                   if bn is not None])
    return [(f"{names_[lay]}.bias", names_[bn]) for lay, bn in pairs]


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
    import torch

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


def bounds(ops: float, nbytes: float, bf16: bool = False) -> dict:
    """The least time for the work, ms: the larger of the bytes over the
    memory rate and the operations over the peak rate, at 3xTF32's
    (bound_ms, the float32 kernels' arithmetic) and at float32's on CUDA
    cores (bound_f32_ms), or for bf16 operands at bf16's on the tensor cores
    (bound_ms only), each with what bounds it."""
    t_bytes = nbytes / HBM_PEAK * 1e3
    out = {}
    peaks = ((("bound", BF16_PEAK),) if bf16 else
             (("bound", TF32X3_PEAK), ("bound_f32", F32_PEAK)))
    for key, peak in peaks:
        t_ops = ops / peak * 1e3
        out[f"{key}_ms"] = max(t_ops, t_bytes)
        out[f"{key}_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


# idle seconds on each side of the launches in a profiled session
PROFILE_PAD_S = 0.05
# what device_us met: readings taken again, and why
DEVICE_US_RETRIES = {"not_backed_up": 0, "below_bound": 0}


def device_records(fn, reps: int, pad_s: float = 0.0, warm: bool = False):
    """The device records (kernels and copies) of ``reps`` calls of ``fn``
    under torch.profiler, with ``pad_s`` idle seconds before the first
    launch and after the card has finished, and with ``warm`` one spin
    kernel launched as the session opens (its record left out); and the
    lead, us: the first record's start less the first host operator's
    (``aten::``) on the profiler's time line, a few us of launch latency
    when nothing is lost and the clocks agree. CUPTI's "Activity Buffer
    Request" marks the profiler's own buffer handling, not work of the
    program."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.events()
    records = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("Activity Buffer")
               and "spin_kernel" not in e.name]
    host = [e.time_range.start for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
    lead = (min(e.time_range.start for e in records) - min(host)
            if records and host else None)
    return records, lead


def whole_calls(records, reps: int) -> bool:
    """Whether ``records`` hold every call's: each device operation's name
    appears a whole number of times per call, and at least one does."""
    names = collections.Counter(e.name for e in records)
    return bool(names) and all(c % reps == 0 for c in names.values())


def device_us(fn, bound_us: float, what: str, reps: int = 20) -> float:
    """Device time per call of ``fn``, us: CUDA events around ``reps``
    calls queued behind a spin kernel, so that the card runs them back to
    back without waiting for the host (the events' gap over ``reps``; the
    card's own gaps between kernels, ~1 us, count). torch.profiler is not
    used: late in a run it loses the records of whole calls
    (profiler_check). A reading whose queue ran dry before the host had
    launched every call is taken again behind a longer spin; one below
    ``bound_us``, the least time the work could take, is taken again; the
    fourth such reading fails the run."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22  # ~2 ms at 1.98 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        backed_up = not start.query()
        end.synchronize()
        us = start.elapsed_time(end) * 1e3 / reps
        if not backed_up:
            DEVICE_US_RETRIES["not_backed_up"] += 1
            cycles *= 4
        elif us < bound_us:
            DEVICE_US_RETRIES["below_bound"] += 1
        else:
            return us
    check(False, f"device time of {what}: {us:.3f} us a call (queue backed "
          f"up: {backed_up}), bound {bound_us:.3f} us")


def profiler_check(sessions: int = 20, reps: int = 20) -> dict:
    """Profiled sessions of ``reps`` K1 launches (the serving chunk's fc0,
    512x64x128, one kernel a call) as they open; with PROFILE_PAD_S of idle
    time around the launches; and with a spin kernel launched first and
    that idle time: for each, how many of ``sessions`` lost device records
    (:func:`whole_calls`) and the median lead of those that lost none
    (:func:`device_records`), us."""
    import statistics

    import torch

    from satae_torch.kernels.matmul import fused_gemm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(CHUNK, 64, device=dev, generator=g)
    b = torch.randn(64, 128, device=dev, generator=g)
    scale, shift = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    fn = lambda: fused_gemm(a, b, scale, shift, "relu", False, False)
    out = {}
    for name, pad, warm in (("as_opened", 0.0, False),
                            ("idle_50ms", PROFILE_PAD_S, False),
                            ("spin_then_idle", PROFILE_PAD_S, True)):
        runs = [device_records(fn, reps, pad, warm) for _ in range(sessions)]
        leads = [lead for rec, lead in runs if whole_calls(rec, reps)]
        out[name] = dict(lost=sessions - len(leads), median_lead_us=(
            statistics.median(leads) if leads else None))
    return out


def f32_route(a, b, ta: bool = False, tb: bool = False) -> str:
    """The K1 route a float32 launch must take on the buffers a and b (2-D,
    or (C, ., .) stacks) read with trans_a / trans_b, the rule restated
    apart from satae_torch's k1_loader: the wgmma kernel ("tma") where
    every buffer's base and rows are 16-byte aligned (TMA reads it), else
    the mma.sync loop ("cp.async"); and the loop also for the launches
    --ab timed faster on it: N <= 16 (the head's forward), an unbatched
    product split into parts of >= 512 of K (the serving projection), a
    batched one with an MN-major B and >= 2^20 multiply-adds a config
    (the vmap path's 4096-wide dX and dW)."""
    ok = all(t.data_ptr() % 16 == 0 and t.shape[-1] * t.element_size() % 16
             == 0 for t in (a, b))
    if not ok:
        return "cp.async"
    m, k = a.shape[-2:][::-1] if ta else a.shape[-2:]
    n = b.shape[-2] if tb else b.shape[-1]
    from satae_torch.kernels.matmul import split_k_plan
    _, _, splits, per = split_k_plan(m, n, k)
    if (n <= 16 or (a.dim() == 2 and splits > 1 and per >= 512)
            or (a.dim() == 3 and not tb and m * n * k >= 1 << 20)):
        return "cp.async"
    return "tma"


def tree_k1_route(mods, a, b, ta: bool, tb: bool) -> str:
    """A tree's k1_loader on a launch: with its trans flags where the
    tree's loader takes them (float32 routes by layout), else on the
    buffers alone; "wide" where the tree has k1_wide and it takes the
    launch."""
    import inspect

    if getattr(mods, "k1_wide", None) is not None and \
            mods.k1_wide(a, b, ta, tb):
        return "wide"
    if len(inspect.signature(mods.k1_loader).parameters) > 2:
        return mods.k1_loader(a, b, ta, tb)
    return mods.k1_loader(a, b)


def f32_conv_args(conv, w):
    """A float32 HWIO conv weight laid out as the tree of module ``conv``
    reads it, and the keyword arguments its conv2d_bn_act takes beside it:
    K-major with its TF32 halves (w_tf32) where the tree has split_tf32,
    else contiguous HWIO; the same values."""
    if not hasattr(conv, "split_tf32"):
        return w.contiguous(), {}
    w = w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    return w, dict(w_tf32=conv.split_tf32(w))


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
    # the decoder's input linear at serving chunk 512, and calibration's
    # latent-128 projection and decoder input, per init
    specs += [("decode", "dec_in fwd", "k1t",
               ((CHUNK, 64), (4096, 64), False, True)),
              ("calibrate", "proj fwd", "k1t",
               ((BATCH, 4096), (128, 4096), False, True)),
              ("calibrate", "dec_in fwd", "k1t",
               ((BATCH, 128), (4096, 128), False, True))]
    return specs


def bf16_launch(path: str, layer: str) -> bool:
    """Whether a launch of :func:`launch_specs` runs in bf16 under satae's
    bf16 recipe: the serving chunk's convolutions and projection, every K1
    launch of the AE step, and the decoder's input. The MLP and calibration
    stay float32."""
    return path in ("ae", "decode") or (
        path == "serve" and (layer.startswith("conv") or layer == "proj"))


def kernel_rows(mods, reference: bool = True, bf16: bool = False,
                outputs: dict = None) -> list:
    """One row per launch of :func:`launch_specs`, on the kernels of
    ``mods`` (a namespace with fused_gemm and conv2d_bn_act, and with
    ``reference`` their plain versions too): back-to-back ms (CUDA events)
    and device us per launch (:func:`device_us`) of the kernel, its bounds,
    and with ``reference`` the plain version's ms and the one library call's
    ms and device us (torch.matmul, or cuDNN's F.conv2d with bias,
    channels-last; TF32 off). With ``bf16`` the launches of the bf16 recipe
    (:func:`bf16_launch`) on bf16 operands (scale and shift float32), the
    library calls in bf16 too, each row's kernel named with ``_bf16``, and
    its route where ``mods`` has ``k1_loader`` / ``conv_route``. With
    ``mods.k_major`` (a tree whose float32 serving fold is K-major) the
    float32 serving launches read the fold's buffers: the conv weights as
    ``mods.conv`` lays them out (:func:`f32_conv_args`), the linear weights
    (N, K); else contiguous HWIO and (K, N), with the same values. With
    ``outputs``, each launch's output (on the CPU) goes into it under
    (kernel, path, layer)."""
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    dt, size = (torch.bfloat16, 2.0) if bf16 else (torch.float32, 4.0)
    k_major = getattr(mods, "k_major", False) and not bf16

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(*shape, device=dev, generator=g) * (hi - lo) + lo

    rows = []
    for path, layer, kind, args in launch_specs():
        if bf16 and not bf16_launch(path, layer):
            continue
        if kind == "k2":
            n, hw, cin, cout = args
            x = rand(n, hw, hw, cin, lo=0.0).to(dt)
            w = (rand(3, 3, cin, cout) / (9 * cin) ** 0.5).to(dt)
            kw_ = {}
            if k_major:
                w, kw_ = f32_conv_args(mods.conv, w)
            scale, shift = rand(cout, lo=0.5, hi=1.5), rand(cout, lo=-0.3,
                                                            hi=0.3)
            oh = hw // 2
            m, k = n * oh * oh, 9 * cin
            shape, trans, name = [n, hw, hw, cin, cout], None, "conv2d_bn_act"
            nbytes = size * (x.numel() + w.numel() + m * cout) + 8.0 * cout
            kern = lambda: mods.conv2d_bn_act(x, w, scale, shift, 2, 1,
                                              "relu", **kw_)
            plain = lambda: mods.conv2d_bn_act_plain(x, w, scale, shift, 2,
                                                     1, "relu")
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of NHWC
            bias = shift.to(dt)
            lib = lambda: F.conv2d(x_nchw, w_oihw, bias, stride=2, padding=1)
            n_out = cout
            route = (mods.conv_route(x, w, 2, 1)[0]
                     if hasattr(mods, "conv_route") else None)
        else:
            if kind == "k1":
                m, k, n_out, act = args
                a, b = torch.randn(m, k, device=dev, generator=g).to(dt), \
                    (rand(k, n_out) / k ** 0.5).to(dt)
                ta, tb = False, k_major
                av, bv = a, b
                if k_major:  # the fold's (N, K) weight, read with w_nk
                    b = b.t().contiguous()
            else:
                a_shape, b_shape, ta, tb = args
                act = "none"
                a = torch.randn(*a_shape, device=dev, generator=g).to(dt)
                b = torch.randn(*b_shape, device=dev, generator=g).to(dt)
                av, bv = (a.t() if ta else a), (b.t() if tb else b)
                m, k, n_out = av.shape[0], av.shape[1], bv.shape[1]
            shape, trans = [m, k, n_out], [ta, tb]
            name = ("fused_gemm" if path == "serve" or layer.endswith("fwd")
                    else "fused_gemm_bwd")
            scale, shift = rand(n_out, lo=0.5, hi=1.5), rand(n_out, lo=-0.3,
                                                            hi=0.3)
            nbytes = size * (m * k + k * n_out + m * n_out) + 8.0 * n_out
            kern = lambda: mods.fused_gemm(a, b, scale, shift, act, ta, tb)
            plain = lambda: mods.fused_matmul_plain(av, bv, scale, shift, act)
            lib = lambda: torch.matmul(av, bv)
            route = (tree_k1_route(mods, a, b, ta, tb)
                     if hasattr(mods, "k1_loader") else None)
        reps = 20 if path == "serve" else 50
        bnd = bounds(2.0 * m * k * n_out, nbytes, bf16)
        what = f"{name} {path} {layer} {shape}"
        row = dict(kernel=name + ("_bf16" if bf16 else ""), path=path,
                   layer=layer, shape=shape, trans=trans, route=route,
                   dtype="bf16" if bf16 else "float32",
                   ms=time_ms(kern, reps=reps),
                   device_us=device_us(kern, bnd["bound_ms"] * 1e3, what),
                   **bnd)
        if outputs is not None:
            outputs[(row["kernel"], path, layer)] = kern().cpu()
        if reference:  # the library's floor: the bytes
            row.update(plain_ms=time_ms(plain, reps=reps),
                       library_ms=time_ms(lib, reps=reps),
                       library_device_us=device_us(
                           lib, nbytes / HBM_PEAK * 1e6, f"library {what}"))
        rows.append(row)
    return rows


def print_rows(rows) -> None:
    for r in rows:
        ref = (f"  plain {r['plain_ms']:.4f}  library {r['library_ms']:.4f} "
               f"ms {r['library_device_us']:.1f} us" if "plain_ms" in r
               else "")
        print(f"  {r['kernel']:19s} {r['path']:5s} {r['layer']:10s} "
              f"{str(r['shape']):24s} trans {str(r['trans']):14s} "
              f"{r.get('route') or '':8s} "
              f"ms {r['ms']:.4f}  device {r['device_us']:.1f} us{ref}  "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']})"
              + (f", f32 {r['bound_f32_ms']:.5f} ({r['bound_f32_by']})"
                 if "bound_f32_ms" in r else ""), flush=True)


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


def bf16_ulp(ref):
    """One bf16 ulp of each value of ``ref`` (8 significant bits):
    2^(floor(log2 |v|) - 7), between 2^-8 and 2^-7 of |v|; 0 at 0."""
    import torch

    r = ref.float().abs()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return torch.where(r > 0, ulp, torch.zeros_like(r))


def ulp_err(out, ref, what: str, bound=None, min_equal: float = 0.99):
    """A bf16 kernel's output against its plain version's on the same card:
    |err| <= one bf16 ulp of ref (or ``bound``) + 1e-6 everywhere, and at
    least ``min_equal`` of the values bit-equal. Returns (max |err|, share
    bit-equal)."""
    import torch

    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"{what}: shape {tuple(out.shape)} vs "
          f"{tuple(ref.shape)}")
    check(out.dtype == ref.dtype, f"{what}: dtype {out.dtype} vs {ref.dtype}")
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out.float() - ref.float()).abs()
    lim = (bf16_ulp(ref) if bound is None else bound) + 1e-6
    bad = int((err > lim).sum())
    check(bad == 0, f"{what}: {bad} elements beyond one bf16 ulp + 1e-6 "
          f"(max |err| {float(err.max()):.3g}, {float((err / lim).max()):.3g}"
          " x the bound)")
    equal = float((out == ref).float().mean())
    check(equal >= min_equal, f"{what}: only {equal:.5f} bit-equal")
    return float(err.max()), equal


def bf16_kernels_phase(card: str, timed: bool = True) -> dict:
    """Phase 13: the bf16 instantiations of K1 (forward and backward) and K2
    against their plain versions on the card, at every bf16 launch of the
    main paths and the awkward shapes; repeated calls bitwise equal; then,
    with ``timed``, their times beside the float32 kernels' and bf16
    cuDNN/cuBLAS."""
    import torch

    from satae_torch.kernels.conv import (conv2d_bn_act, conv2d_bn_act_plain,
                                          conv_route)
    from satae_torch.kernels.matmul import (fused_gemm, fused_matmul,
                                            fused_matmul_bwd_plain,
                                            fused_matmul_plain, k1_loader,
                                            split_k_plan, split_k_plan_tma)

    bf = torch.bfloat16
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, device=dev, generator=g) * (hi - lo) + lo

    def affine(n):
        return rand(n, lo=0.5, hi=1.5), rand(n, lo=-0.3, hi=0.3)

    def operands(m, k, n, ta=False, tb=False, offset=0):
        """bf16 A (m, k) and B (k, n) in their buffers' layouts (A as a
        (k, m) buffer with ``ta``, B as an (n, k) one with ``tb``), the
        buffers starting ``offset`` elements into their storage."""
        a = torch.randn(m, k, device=dev, generator=g).to(bf)
        b = (rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5).to(bf)

        def buf(t, trans):
            t = t.t().contiguous() if trans else t
            if not offset:
                return t
            store = torch.empty(t.numel() + offset, device=dev, dtype=bf)
            view = store[offset:].view(t.shape)
            view.copy_(t)
            return view
        return a, b, buf(a, ta), buf(b, tb)

    res = dict(k1=[], k2=[], bwd=[])
    k1_err, k1_min_eq = 0.0, 1.0

    def k1_case(what, m, k, n, ta, tb, acts, offset=0, repeat=False):
        nonlocal k1_err, k1_min_eq
        a, b, a_buf, b_buf = operands(m, k, n, ta, tb, offset)
        scale, shift = affine(n)
        loader = k1_loader(a_buf, b_buf)
        plan = (split_k_plan_tma if loader == "tma" else split_k_plan)(m, n, k)
        for act in acts:
            out = fused_gemm(a_buf, b_buf, scale, shift, act, ta, tb)
            err, eq = ulp_err(out, fused_matmul_plain(a, b, scale, shift, act),
                              f"bf16 K1 {what} {(m, k, n)} trans_a={ta} "
                              f"trans_b={tb} offset {offset} {act} ({loader}, "
                              f"plan {plan})")
            k1_err, k1_min_eq = max(k1_err, err), min(k1_min_eq, eq)
            res["k1"].append(dict(what=what, shape=[m, k, n], trans=[ta, tb],
                                  offset=offset, act=act, loader=loader,
                                  plan=list(plan), max_abs_err=err,
                                  bit_equal=eq))
        if repeat:
            first = fused_gemm(a_buf, b_buf, scale, shift, "relu", ta, tb)
            check(all(torch.equal(first, fused_gemm(
                a_buf, b_buf, scale, shift, "relu", ta, tb))
                for _ in range(4)), f"bf16 K1 {(m, k, n)} trans_a={ta} "
                f"trans_b={tb}: repeated calls differ bitwise")

    # the serving projection of a 512-image chunk, and 8192 rows (one split)
    k1_case("serve proj", CHUNK, 4096, 64, False, False, ACTS, repeat=True)
    k1_case("one split", 8192, 4096, 64, False, False, ("none",))
    # every K1 launch of a batch-64 AE step and the decoder's input, in its
    # own layout
    for path, layer, kind, args in launch_specs():
        if kind == "k1t" and bf16_launch(path, layer):
            a_shape, b_shape, ta, tb = args
            m, k = a_shape[::-1] if ta else a_shape
            n = b_shape[0] if tb else b_shape[1]
            k1_case(f"{path} {layer}", m, k, n, ta, tb,
                    ("none",) if path == "ae" else ACTS, repeat=True)
    # the small products of the JAX package's kernel tests, odd K and N (the
    # 2-byte copies), a buffer at an odd element offset
    for m, k, n in ((7, 33, 10), (1, 64, 10), (33, 1001, 11), (5, 17, 3)):
        for ta, tb in LAYOUTS:
            k1_case("small", m, k, n, ta, tb, ACTS)
    for ta, tb in LAYOUTS:
        k1_case("odd offset", 64, 4096, 64, ta, tb, ("none",), offset=1)
        k1_case("odd offset", 33, 40, 24, ta, tb, ("relu",), offset=3)
    # the split-K and ragged-K shapes in every layout and activation
    for m, k, n in SPLIT_SHAPES:
        for ta, tb in LAYOUTS:
            k1_case("split-K", m, k, n, ta, tb, ACTS, repeat=True)
    # the wgmma route's own edges: TMA boxes cut at ragged M, N and K,
    # clusters of 1 to 16 splits, K ending inside a stage
    for m, k, n in TMA_EDGE_SHAPES:
        for ta, tb in LAYOUTS:
            k1_case("tma edge", m, k, n, ta, tb, ACTS, repeat=True)
    by_loader = collections.Counter(c["loader"] for c in res["k1"])
    print(f"bf16 K1 vs plain: {len(res['k1'])} cases ({dict(by_loader)}), "
          f"max |err| {k1_err:.3g}, least share bit-equal {k1_min_eq:.5f}, "
          "tolerance one bf16 ulp + 1e-6, >= 99 % bit-equal; repeated calls "
          "bitwise equal", flush=True)
    # every bf16 K1 launch of the main paths runs wgmma, but the head's
    # backward, whose cotangent rows are 10 bf16 (20 bytes: no TMA)
    on_mma = sorted({c["what"] for c in res["k1"] if c["what"].startswith(
        ("serve", "ae", "decode")) and c["loader"] != "tma"})
    print(f"bf16 K1 main-path launches on the cp.async mma.sync loop: "
          f"{on_mma}", flush=True)
    check(on_mma == ["ae fc2 dW", "ae fc2 dX"], f"bf16 K1 main-path launches "
          f"off the wgmma route: {on_mma}")

    # the backward in bf16 (nn.Linear weight layout, scale with a gradient:
    # the z recompute) against fused_matmul_bwd_plain on the kernel's y
    bwd_err, bwd_min_eq, dsc_min_eq = 0.0, 1.0, 1.0
    ae_fwd = [(BATCH, 4096, 64), (BATCH, 64, 4096), (BATCH, 64, 128),
              (BATCH, 128, 10), (7, 33, 10), (1, 64, 10)]
    for (m, k, n), act in itertools.product(ae_fwd, ACTS):
        x = torch.randn(m, k, device=dev, generator=g).to(bf)
        w = (rand(n, k, lo=-1.0, hi=1.0) / k ** 0.5).to(bf)
        scale, shift = affine(n)
        cot = torch.randn(m, n, device=dev, generator=g).to(bf)
        leaves = [t.clone().requires_grad_() for t in (x, w, scale, shift)]
        y = fused_matmul(*leaves, act, w_nk=True)
        check(y.dtype == bf, f"bf16 K1 forward gives {y.dtype}")
        y.backward(cot)
        ref = fused_matmul_bwd_plain(cot, x, w, scale, y.detach(), act,
                                     w_nk=True)
        # dscale sums the bf16 terms g * z in the same reduction on both
        # sides, so only the rows where K1's z differs from the plain z (by
        # one ulp at most, held above) move it: by |g| ulp(z) and two ulps
        # of the term's rounding each (|g| <= |cot| through every act); the
        # sum's rounding to bf16 adds two ulps of dscale
        z = fused_matmul_plain(x, w.t(), None, torch.zeros(n, device=dev))
        z_k = fused_gemm(x, w, None, None, "none", False, True)
        z_abs = torch.maximum(z.float().abs(), z_k.float().abs())
        moved = torch.where(
            z_k != z, cot.float().abs() * bf16_ulp(z_abs)
            + 2 * bf16_ulp(cot.float().abs() * z_abs), torch.zeros_like(z_abs))
        bounds_ = [None, None, moved.sum(0) + 2 * bf16_ulp(ref[2]), None]
        for name, leaf, r, bnd in zip(("dx", "dw", "dscale", "dshift"),
                                      leaves, ref, bounds_):
            what = f"bf16 K1 backward {name} {(m, k, n)} {act}"
            check(leaf.grad.dtype == r.dtype, f"{what}: {leaf.grad.dtype} "
                  f"vs {r.dtype}")
            if name == "dshift":
                check(torch.equal(leaf.grad, r), f"{what}: differs")
                continue
            err, eq = ulp_err(leaf.grad, r, what, bound=bnd,
                              min_equal=0.99 if name in ("dx", "dw") else 0.0)
            bwd_err = max(bwd_err, err)
            if name in ("dx", "dw"):
                bwd_min_eq = min(bwd_min_eq, eq)
            else:
                dsc_min_eq = min(dsc_min_eq, eq)
        res["bwd"].append(dict(shape=[m, k, n], act=act))
    print(f"bf16 K1 backward vs fused_matmul_bwd_plain: {len(res['bwd'])} "
          f"cases, dx and dw within one bf16 ulp, least share bit-equal "
          f"{bwd_min_eq:.5f}; dscale within the summed rounding of the g z "
          f"terms whose z differs, least share bit-equal {dsc_min_eq:.5f}; "
          f"dshift equal; max |err| {bwd_err:.3g}", flush=True)

    # K2: the four encoder layers of a 512-image chunk (conv0 on the
    # staged-rows kernel, conv1-3 TMA's im2col mode: 32 and 64 channels a
    # load), Cin 5 and 6 (the 2- and 4-byte copies of the mma.sync loop),
    # Cin 8 and 16 (its 16-byte copies), ragged 32/64-wide tiles, and each
    # wgmma route at ragged M and N: the staged rows (a 32 x 32 image, 16
    # channels out), im2col (Cin 64 and 128, Cout 72 and 64; Cin 32 on a
    # 7 x 7 image)
    chans = (3, 32, 64, 128, 256)
    k2_err, k2_min_eq = 0.0, 1.0
    routes = {}
    for n, hw, cin, cout in ([(CHUNK, 64 >> i, chans[i], chans[i + 1])
                              for i in range(4)]
                             + [(3, 7, 5, 9), (2, 9, 6, 40), (3, 11, 8, 72),
                                (2, 10, 3, 40), (5, 13, 16, 24),
                                (4, 32, 3, 16), (2, 9, 64, 72),
                                (3, 12, 128, 64), (2, 9, 32, 72),
                                (3, 7, 32, 40)]):
        x = rand(n, hw, hw, cin).to(bf)
        w = (rand(3, 3, cin, cout, lo=-1.0, hi=1.0) / (9 * cin) ** 0.5).to(bf)
        scale, shift = affine(cout)
        route = conv_route(x, w, 2, 1)[0]
        routes[(n, hw, cin, cout)] = route
        for act in (("relu",) if n == CHUNK else ACTS):
            out = conv2d_bn_act(x, w, scale, shift, 2, 1, act)
            err, eq = ulp_err(out, conv2d_bn_act_plain(x, w, scale, shift, 2,
                                                       1, act),
                              f"bf16 K2 {(n, hw, hw, cin, cout)} {act} "
                              f"({route})")
            k2_err, k2_min_eq = max(k2_err, err), min(k2_min_eq, eq)
            res["k2"].append(dict(shape=[n, hw, hw, cin, cout], act=act,
                                  route=route, max_abs_err=err, bit_equal=eq))
        if n == CHUNK:  # every route of the serving chunk repeats bitwise
            first = conv2d_bn_act(x, w, scale, shift, 2, 1, "relu")
            check(all(torch.equal(first, conv2d_bn_act(
                x, w, scale, shift, 2, 1, "relu")) for _ in range(4)),
                f"bf16 K2 Cin {cin}: repeated calls differ bitwise")
    serve_routes = [routes[(CHUNK, 64 >> i, chans[i], chans[i + 1])]
                    for i in range(4)]
    print(f"bf16 K2 vs plain: {len(res['k2'])} cases, max |err| "
          f"{k2_err:.3g}, least share bit-equal {k2_min_eq:.5f}; routes "
          f"{ {str(k): v for k, v in routes.items()} }; conv0-3 5 calls "
          "bitwise equal", flush=True)
    check(serve_routes == ["rows", "im2col", "im2col", "im2col"],
          f"bf16 K2 serving layers on routes {serve_routes}")
    res.update(k1_err=k1_err, k1_min_equal=k1_min_eq, bwd_err=bwd_err,
               bwd_min_equal=bwd_min_eq, dscale_min_equal=dsc_min_eq,
               k2_err=k2_err, k2_min_equal=k2_min_eq)
    if not timed:
        return res

    rows = kernel_rows(SimpleNamespace(
        fused_gemm=fused_gemm, fused_matmul_plain=fused_matmul_plain,
        conv2d_bn_act=conv2d_bn_act, conv2d_bn_act_plain=conv2d_bn_act_plain,
        k1_loader=k1_loader, conv_route=conv_route), bf16=True)
    print(f"per launch in bf16, serving chunk of {CHUNK} and a batch-{BATCH} "
          f"AE step (bounds at 2 B an element and 989 TFLOP/s; card "
          f"{card}):", flush=True)
    print_rows(rows)
    res["rows"] = rows
    return res


def profile_device(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, device-busy ms, device
    events by start). Device work = kernel and memcpy events on the card;
    busy time is the union of their intervals. CUPTI's "Activity Buffer
    Request" marks the profiler's own buffer handling, not work of the
    program. The session opens with a spin kernel (its record left out) and
    PROFILE_PAD_S of idle time, and closes with that idle time, outside the
    wall time (profiler_check)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    events = [e for e in sorted(prof.events(),
                                key=lambda e: e.time_range.start)
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")
              and "spin_kernel" not in e.name]
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
                                    PipelineConfig, throughput_config)
    from satae_torch.data.augment import normalize
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.kernels import _build
    from satae_torch.kernels import conv as conv_mod
    from satae_torch.kernels.conv import conv2d_bn_act, conv2d_bn_act_plain
    from satae_torch.kernels.conv import conv_route
    from satae_torch.kernels.matmul import (fused_gemm, fused_matmul,
                                            fused_matmul_bwd,
                                            fused_matmul_bwd_plain,
                                            fused_matmul_plain, k1_loader,
                                            split_k_plan, split_k_plan_tma)
    from satae_torch.models.mlp import MLP
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn import layers as L
    from satae_torch.nn.init import init_
    from satae_torch.train import hbm
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
    check(len(ptxas) == N_INSTANTIATIONS, f"{len(ptxas)} kernel "
          f"instantiations in the ptxas report, expected {N_INSTANTIATIONS} "
          "(K1 16 mma.sync + 9 wgmma + 4 wide, K2 4 mma.sync + 5 wgmma "
          "+ 1, attention 1, LayerNorm 1)")
    spilled = [r["kernel"] for r in ptxas
               if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"ptxas spills registers in {spilled}")
    hgmma = hgmma_counts()
    for name, n in hgmma.items():
        print(f"  SASS {name}: {n} HGMMA", flush=True)
    check(len(hgmma) == N_WGMMA and all(hgmma.values()),
          f"expected {N_WGMMA} kernels running wgmma, float32 and bf16 "
          f"(HGMMA in their SASS), found {hgmma}")
    serialised = wgmma_serialised()
    print(f"  ptxas wgmma serialisation notes (C75xx): {serialised or 'none'}",
          flush=True)
    check(not serialised, f"ptxas serialised wgmmas: {serialised}")

    # The plain versions are the reference: full float32, no TF32. Phases
    # 17-20 get PyTorch's defaults back.
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, device=dev, generator=g) * (hi - lo) + lo

    def affine(n):
        return rand(n, lo=0.5, hi=1.5), rand(n, lo=-0.3, hi=0.3)

    # -- 3. K1 --------------------------------------------------------------
    def plan_of(m, n, k, route):  # the float32 plan of a route
        return (split_k_plan_tma(m, n, k, dtype=torch.float32)
                if route == "tma" else split_k_plan(m, n, k))

    def held_route(a_buf, b_buf, what, ta=False, tb=False):  # held
        route, want = k1_loader(a_buf, b_buf, ta, tb), f32_route(
            a_buf, b_buf, ta, tb)
        check(route == want, f"{what}: K1 on {route}, expected {want}")
        return route

    k1_err, k1_routes = 0.0, collections.Counter()
    for m, k, n in K1_SHAPES:
        x = torch.randn(m, k, device=dev, generator=g)
        w = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = affine(n)
        k1_routes[held_route(x, w, f"K1 {(m, k, n)}")] += 1
        for act in ACTS:
            k1_err = max(k1_err, max_err(
                fused_matmul(x, w, scale, shift, act),
                fused_matmul_plain(x, w, scale, shift, act),
                f"K1 {(m, k, n)} {act}"))
    print(f"K1 fused_gemm vs plain: {len(K1_SHAPES) * 3} cases (routes "
          f"{dict(k1_routes)}), max |err| {k1_err:.3g}", flush=True)
    for path, layer, _, (a_shape, b_shape, _, tb) in launch_specs():
        if path not in ("decode", "calibrate"):
            continue
        (m, k), n = a_shape, b_shape[0]
        route = held_route(torch.empty(a_shape, device=dev),
                           torch.empty(b_shape, device=dev),
                           f"{path} {layer}", tb=tb)
        check(route == "tma", f"{path} {layer}: float32 K1 on {route}")
        tile_m, tile_n, splits_, per = plan_of(m, n, k, route)
        tiles = -(-m // tile_m) * -(-n // tile_n)
        print(f"  K1 {(m, k, n)} ({layer}): {route}, plan {tiles} tiles of "
              f"{tile_m}x{tile_n} x {splits_} splits of {per} = "
              f"{tiles * splits_} blocks", flush=True)
    split_err, plans = 0.0, {}
    for m, k, n in SPLIT_SHAPES:
        a = torch.randn(m, k, device=dev, generator=g)
        b = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = affine(n)
        plans[(m, k, n)] = {}
        for ta, tb in LAYOUTS:
            a_buf = a.t().contiguous() if ta else a
            b_buf = b.t().contiguous() if tb else b
            route = held_route(a_buf, b_buf, f"K1 {(m, k, n)} {ta} {tb}",
                               ta, tb)
            plans[(m, k, n)][f"{ta} {tb}"] = [route, plan_of(m, n, k, route)]
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
        for lay, (route, (tile_m, tile_n, splits, per)) in \
                plans[(m, k, n)].items():
            tiles = -(-m // tile_m) * -(-n // tile_n)
            print(f"  K1 {(m, k, n)} trans_a, trans_b {lay}: {route}, plan "
                  f"{tiles} tiles of {tile_m}x{tile_n} x {splits} splits of "
                  f"{per} = {tiles * splits} blocks", flush=True)
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
    k2_err, k2_routes = 0.0, {}
    for n, hw, cin, cout in K2_SHAPES:
        x = rand(n, hw, hw, cin)
        # the float32 layout (K-major) and its TF32 halves, as the fold has
        # them
        w, kw_ = f32_conv_args(conv_mod, rand(
            3, 3, cin, cout, lo=-1.0, hi=1.0) / (9 * cin) ** 0.5)
        k2_routes[(n, hw, cin, cout)] = conv_route(x, w, 2, 1)[0]
        scale, shift = affine(cout)
        acts = ("relu",) if n == CHUNK else ACTS
        for act in acts:
            k2_err = max(k2_err, max_err(
                conv2d_bn_act(x, w, scale, shift, 2, 1, act, **kw_),
                conv2d_bn_act_plain(x, w, scale, shift, 2, 1, act),
                f"K2 {(n, hw, hw, cin, cout)} {act}"))
        if (n, cin) == (CHUNK, 32):
            conv1 = x, w, scale, shift, kw_
    x, w, scale, shift, kw_ = conv1
    first = conv2d_bn_act(x, w, scale, shift, 2, 1, "relu", **kw_)
    check(all(torch.equal(first, conv2d_bn_act(x, w, scale, shift, 2, 1,
                                               "relu", **kw_))
              for _ in range(4)), "K2 conv1: repeated calls differ bitwise")
    # the layout of the other dtype, and the im2col kernel without its
    # TF32 halves, are refused, never copied or split per call
    for bad, kw_bad in ((w.contiguous(), kw_), (w, {})):
        try:
            conv2d_bn_act(x, bad, scale, shift, 2, 1, "relu", **kw_bad)
            check(False, "K2 took a float32 weight it does not read")
        except ValueError:
            pass
    serve_k2 = [k2_routes[s_] for s_ in K2_SHAPES[:4]]
    print(f"K2 conv2d_bn_act vs plain: 13 cases (Cin 3, 5 and 6: 4-byte "
          f"copies; Cout 9, 40, 72: ragged 32/64-wide tiles), max |err| "
          f"{k2_err:.3g}; routes {list(k2_routes.values())}; conv1 5 calls "
          "bitwise equal; a contiguous HWIO float32 weight and a missing "
          "w_tf32 refused", flush=True)
    check(serve_k2 == ["rows", "im2col", "im2col", "im2col"],
          f"float32 K2 serving layers on routes {serve_k2}")

    # -- 5. time ------------------------------------------------------------
    all_rows = kernel_rows(SimpleNamespace(
        fused_gemm=fused_gemm, fused_matmul_plain=fused_matmul_plain,
        conv2d_bn_act=conv2d_bn_act, conv2d_bn_act_plain=conv2d_bn_act_plain,
        k1_loader=k1_loader, conv_route=conv_route, k_major=True,
        conv=conv_mod))
    # every float32 main-path launch on wgmma, but the head's backward
    # (10-wide cotangent rows: 40 bytes, no TMA), and its forward (N = 10)
    # and the serving projection (8 splits of 512), which --ab timed faster
    # on the mma.sync loop (k1_loader)
    off_wgmma = sorted(f"{r['path']} {r['layer']}" for r in all_rows
                       if r["route"] not in ("tma", "rows", "im2col"))
    print(f"float32 main-path launches off the wgmma route: {off_wgmma}",
          flush=True)
    check(off_wgmma == ["ae fc2 dW", "ae fc2 dX", "ae fc2 fwd", "mlp fc2 dW",
                        "mlp fc2 dX", "mlp fc2 fwd", "serve fc2",
                        "serve proj"],
          f"float32 main-path launches off the wgmma route: {off_wgmma}")
    rows = [r for r in all_rows if r["path"] == "serve"]
    train_rows = [r for r in all_rows if r["path"] in ("ae", "mlp")]
    new_rows = [r for r in all_rows if r["path"] in ("decode", "calibrate")]
    print(f"per launch, serving chunk of {CHUNK} (card {card}):", flush=True)
    print_rows(rows)
    print("per launch, the decoder's and calibration's K1 products:",
          flush=True)
    print_rows(new_rows)
    # the profiler's capture early in the run (phase 5 took ~100 readings)
    prof_check = {"early": profiler_check()}
    print(f"profiler check after phase 5, of 20 sessions each: "
          f"{prof_check['early']}", flush=True)

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
    check(launches == counts(fused_gemm=4 * n_chunks,
                             conv2d_bn_act=4 * n_chunks),
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

    # K2's and K1's kernels by name (float32 serving runs the wgmma ones)
    layers = {("conv2d_bn_act_kernel", "conv_rows_kernel",
               "conv_im2col_tma_kernel"): ("conv0", "conv1", "conv2",
                                           "conv3"),
              ("fused_gemm_kernel", "fused_gemm_tma_kernel"): (
                  "proj", "fc0", "fc1", "fc2")}
    for _ in range(3):  # the profiler may lose records (profiler_check)
        wall_ms, dev_ms, events = profile_device(
            lambda: pipe.predict(test.images))
        seq = {k: [e.time_range.elapsed_us() for e in events
                   if any(name in e.name for name in k)] for k in layers}
        if all(len(v) == 4 * n_chunks for v in seq.values()):
            break
    check(all(len(v) == 4 * n_chunks for v in seq.values()),
          f"the profile of one predict holds {[len(v) for v in seq.values()]}"
          f" K2 / K1 records, expected {4 * n_chunks} of each")
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
    layout_err, layout_routes = 0.0, collections.Counter()
    for m, k, n in products:
        a = torch.randn(m, k, device=dev, generator=g)
        b = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = affine(n)
        ref = fused_matmul_plain(a, b, scale, shift)
        for ta, tb in itertools.product((False, True), repeat=2):
            a_buf = a.t().contiguous() if ta else a
            b_buf = b.t().contiguous() if tb else b
            layout_routes[held_route(a_buf, b_buf, f"K1 layout {(m, k, n)} "
                                     f"{ta} {tb}")] += 1
            out = fused_gemm(a_buf, b_buf, scale, shift, "none", ta, tb)
            layout_err = max(layout_err, max_err(
                out, ref, f"K1 layout {(m, k, n)} trans_a={ta} "
                f"trans_b={tb}"))
    print(f"K1 layouts vs plain: {4 * len(products)} cases (every "
          "(trans_a, trans_b) at the forward, dX and dW products of a "
          f"batch-{BATCH} train step; routes {dict(layout_routes)}), max "
          f"|err| {layout_err:.3g}, tolerance 1e-4 + 1e-5*|ref|", flush=True)

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
        if (m, k, n) in train_fwd:  # fwd x @ W^T, dX gs @ W, dW gs^T @ x
            routes = tuple(held_route(a_, b_, f"K1 backward {(m, k, n)}")
                           for a_, b_ in ((x, w), (cot, w), (cot, x)))
            want = ("tma",) * 3 if n % 4 == 0 else ("tma", "cp.async",
                                                    "cp.async")
            check(routes == want, f"K1 {(m, k, n)} fwd / dX / dW on "
                  f"{routes}, expected {want}")
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
    before = fused_matmul_bwd.launches[""]
    got = torch.autograd.grad(L.linear(x, w, bias, "relu"), (x, w, bias), cot)
    check(fused_matmul_bwd.launches[""] - before == 2,
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
        check(ae_parity["launches"] == counts(
            fused_gemm=PARITY_STEPS * n_lin_ae,
            fused_gemm_bwd=PARITY_STEPS * 2 * n_lin_ae),
            f"AE step launches {ae_parity['launches']}")
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
        check(mlp_parity["launches"] == counts(
            fused_gemm=PARITY_STEPS * n_lin_mlp,
            fused_gemm_bwd=PARITY_STEPS * (2 * n_lin_mlp - 1)),
            f"MLP step launches {mlp_parity['launches']}")

    # -- 10. fit ------------------------------------------------------------
    fit = fit_phase(fit_cfg, raw, splits, "fit",
                    recorded_val_loss=RECORDED_FIT_AE_VAL_LOSS)
    fit_launches, summary, hist = fit["launches"], fit["summary"], fit["hist"]
    n_tr = len(splits.train)

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
    k1_records = sum("fused_gemm" in e.name for e in tr_events)
    print(f"profile of 5 AE steps: wall {tr_wall:.3f} ms, device busy "
          f"{tr_dev:.3f} ms ({100 * tr_dev / tr_wall:.1f}%), idle "
          f"{100 * (1 - tr_dev / tr_wall):.1f}%, {len(tr_events)} device "
          f"events, K1 records {k1_records} of the 5 x 12 launched (fewer: "
          f"the profiler lost records, see profiler_check); with the "
          f"deterministic algorithms: wall {det_wall:.3f} ms, device busy "
          f"{det_dev:.3f} ms, {len(det_events)} device events", flush=True)
    for t, count, key in tr_top:
        print(f"  {t:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)

    # -- 12. grid -----------------------------------------------------------
    grid = grid_phase(card)
    grid_launches = grid["launches"]

    # -- 13. bf16 kernels ---------------------------------------------------
    k13 = bf16_kernels_phase(card)

    # -- 14. bf16 serve -----------------------------------------------------
    serve16 = bf16_serve_phase(card, cfg.data, test, ips)

    # -- 15. bf16 fit, the throughput recipe, step times ---------------------
    bf16_rt = dataclasses.replace(fit_cfg.runtime, compute_dtype="bfloat16")
    fit16 = fit_phase(dataclasses.replace(fit_cfg, runtime=bf16_rt), raw,
                      splits, "bf16 fit")
    tp_cfg = throughput_config(dataclasses.replace(fit_cfg, runtime=bf16_rt))
    fit_tp = fit_phase(tp_cfg, raw, splits, "bf16 throughput fit",
                       repeat=False)
    # the recipe's step: the AE and MLP epoch bodies at batch 1024, the AE
    # in bf16 and in float32 in turns, with fit's deterministic cuDNN
    tb = tp_cfg.data.batch_size
    order_tp = hbm.epoch_order(n_tr, tb, 0, 0)
    n_tp = len(order_tp) - 2
    ae_tp = {}
    for dt in (torch.float32, torch.bfloat16):
        model = SupervisedAE(mcfg, dcfg.channels, dcfg.image_size)
        init_(model, torch.Generator().manual_seed(0))
        model.to(dev)
        ae_tp[dt] = (model, adam_init(list(model.parameters())))
    ae_tp_run = lambda dt: lambda n_: hbm.ae_train_epoch(
        *ae_tp[dt], imgs_tr, labs_tr, order_tp[:n_], 20.0, 1e-4,
        tp_cfg.data, g, dt)
    tp_ms = {torch.float32: [], torch.bfloat16: []}
    with det_flags(True):
        for dt in (torch.float32, torch.bfloat16, torch.bfloat16,
                   torch.float32):
            tp_ms[dt].append(time_epoch_body(ae_tp_run(dt), n_tp))
        mlp_tp = MLP(mcfg)
        init_(mlp_tp, torch.Generator().manual_seed(1))
        mlp_tp.to(dev)
        mlp_tp_opt = adam_init(list(mlp_tp.parameters()))
        mlp_tp_ms = time_epoch_body(lambda n_: hbm.mlp_train_epoch(
            mlp_tp, mlp_tp_opt, xs, labs_tr, order_tp[:n_], 1e-4, 1e-4, g),
            n_tp)
    model, opt = ae_tp[torch.bfloat16]
    check(all(t.dtype == torch.float32 for t in opt.mu + opt.nu)
          and all(v.dtype == torch.float32 for v in
                  model.state_dict().values() if v.is_floating_point()),
          "bf16 steps: Adam's moments or the master state are not float32")
    tp_f32_ms, tp_bf16_ms = (sum(tp_ms[d]) / 2 for d in tp_ms)
    print(f"throughput recipe steps (epoch bodies, {n_tp} steps of batch "
          f"{tb}, deterministic cuDNN, in turns f32, bf16, bf16, f32): AE "
          f"bf16 {tp_bf16_ms:.3f} ms/step ({tb / tp_bf16_ms * 1e3:.1f} "
          f"images/s), AE float32 {tp_f32_ms:.3f} ms/step "
          f"({tb / tp_f32_ms * 1e3:.1f} images/s), runs "
          f"{[round(x, 3) for x in tp_ms[torch.bfloat16]]} / "
          f"{[round(x, 3) for x in tp_ms[torch.float32]]}; MLP (float32 in "
          f"both) {mlp_tp_ms:.3f} ms/step ({tb / mlp_tp_ms * 1e3:.1f} "
          f"images/s); Adam moments and master state float32 after the bf16 "
          f"steps; card {card}", flush=True)

    # model-FLOPs utilization of the AE steps of phases 11 and 15
    # (satae_torch.utils.roofline: satae's FLOPs model, the H100's peaks)
    from satae_torch.utils.roofline import step_utilizations
    kind = torch.cuda.get_device_name(0)
    mfu = {name: step_utilizations(mcfg, data_, batch=b, step_seconds=ms_
                                   / 1e3, dtype=dt, device_kind=kind)
           for name, data_, b, ms_, dt in (
               ("ae_b64_f32", dcfg, BATCH, ae_step_ms, "f32"),
               ("ae_b64_f32_deterministic", dcfg, BATCH, ae_step_det_ms,
                "f32"),
               ("ae_b1024_f32", tp_cfg.data, tb, tp_f32_ms, "f32"),
               ("ae_b1024_bf16", tp_cfg.data, tb, tp_bf16_ms, "bf16"))}
    print("model-FLOPs MFU of the AE train step (satae's FLOPs model, "
          "peaks 67 TFLOP/s float32, 989 bf16): " + ", ".join(
              f"{k} {v.get('mfu')} ({v.get('flops_per_image_model')} "
              f"FLOP/image)" for k, v in mfu.items()) + f"; card {card}",
          flush=True)

    # -- 16. bf16 grid ------------------------------------------------------
    grid16 = grid_phase(card, bf16=True)

    # -- 17. decoder serving ------------------------------------------------
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    print(f"phases 17-20 with PyTorch's default TF32 flags: matmul "
          f"{tf32_defaults[0]}, cuDNN {tf32_defaults[1]}", flush=True)
    t_new = time.perf_counter()
    decode = decode_phase(card, cfg.data, test)
    phase_s = {17: time.perf_counter() - t_new}

    # -- 18. calibration ----------------------------------------------------
    t_new = time.perf_counter()
    calib = calibrate_phase(card, splits, cfg.data)
    phase_s[18] = time.perf_counter() - t_new

    # -- 19. in-flight resume -----------------------------------------------
    t_new = time.perf_counter()
    inflight = inflight_phase(card)
    phase_s[19] = time.perf_counter() - t_new

    # -- 20. CLI ------------------------------------------------------------
    t_new = time.perf_counter()
    cli_res = cli_phase(card)
    phase_s[20] = time.perf_counter() - t_new
    print("seconds of phases 17-20: " + ", ".join(
        f"{k} {v:.2f}" for k, v in phase_s.items()), flush=True)
    prof_check["late"] = profiler_check()
    print(f"profiler check after phase 20, of 20 sessions each: "
          f"{prof_check['late']}; device_us took readings again "
          f"{DEVICE_US_RETRIES}", flush=True)

    # -- 21-24. the config-batched (vmap) and per-batch sweep engines -------
    # TF32 off again: the plain references are full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_new = time.perf_counter()
    k21 = batched_kernels_phase(card)
    phase_s[21] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    stacked = stacked_steps_phase(card, splits, k21["rows"])
    phase_s[22] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    vgrid = vmap_grid_phase(card)
    phase_s[23] = time.perf_counter() - t_new
    t_new = time.perf_counter()
    steps_eng = steps_engine_phase(card)
    phase_s[24] = time.perf_counter() - t_new
    print("seconds of phases 21-24: " + ", ".join(
        f"{k} {v:.2f}" for k, v in phase_s.items() if k > 20), flush=True)

    # -- 25-28. the multi-device runtime --------------------------------------
    par = parallel_phases(card, fit_cfg, raw, splits, cfg.data, fit, grid)
    phase_s.update(par["seconds"])

    # -- 29. the end-to-end example, as a user runs it ---------------------
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    t_new = time.perf_counter()
    example = example_phase(card)
    phase_s[29] = time.perf_counter() - t_new
    print(f"seconds of phase 29: {phase_s[29]:.2f}", flush=True)

    # -- report -------------------------------------------------------------
    def entry(name, source, replaces, err, rs, per, paths):
        ops_ms = sum(r["bound_ms"] for r in rs
                     if r["bound_by"] == "operations")
        by_path = {p: sum(c[name] for c in cs) for p, cs in paths.items()}
        out_ = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err,
            "tolerance": ("one bf16 ulp + 1e-6, >= 99 % bit-equal"
                          if name.endswith("_bf16") else "1e-4 + 1e-5*|ref|"),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": ("operations" if 2 * ops_ms >= sum(
                r["bound_ms"] for r in rs) else "bytes"),
            "library_ms": sum(r["library_ms"] for r in rs),
            "device_us": sum(r["device_us"] for r in rs),
            "library_device_us": sum(r["library_device_us"] for r in rs),
            "per": f"{per} ({len(rs)} launch{'' if len(rs) == 1 else 'es'})",
        }
        if all("bound_f32_ms" in r for r in rs):
            out_["bound_f32_ms"] = sum(r["bound_f32_ms"] for r in rs)
        return out_

    cli_launches = [v["launches"] for v in cli_res["subcommands"].values()]
    f32_paths = {"serve": [launches], "fit": [fit_launches],
                 "grid": [grid_launches],
                 "decode": [decode["float32"]["launches"],
                            decode["float32"]["decode_launches"]],
                 "calibrate": [calib["launches"]],
                 "inflight": [inflight["launches"]], "cli": cli_launches,
                 "dp_fit": [par[25]["launches"]],
                 "dp_two_ranks": [par[26]["launches_per_rank"]] * 2,
                 "sharded_grid": [par[27]["launches"],
                                  *par[27]["launches_per_rank_of_two"]],
                 "sharded_serve": [*par[28]["launches"].values(),
                                   par[28]["cli"]["launches"]],
                 "example": [example["launches"]]}
    bf16_paths = {"serve": [serve16["launches"]],
                  "fit": [fit16["launches"], fit_tp["launches"]],
                  "grid": [grid16["launches"]],
                  "decode": [decode["bfloat16"]["launches"],
                             decode["bfloat16"]["decode_launches"]]}
    rows16 = k13["rows"]
    k1, k2 = "satae_torch/csrc/fused_gemm.cu", "satae_torch/csrc/conv_bn_act.cu"
    chunk, step = f"one {CHUNK}-image serving chunk", \
        f"one batch-{BATCH} AE train step"
    report = {"kernels": [
        entry("fused_gemm", k1, "satae/kernels/matmul.py:36",
              max(k1_err, layout_err),
              [r for r in rows if r["kernel"] == "fused_gemm"], chunk,
              f32_paths),
        entry("fused_gemm_bwd", k1, "satae/kernels/matmul.py:100", bwd_err,
              [r for r in train_rows if r["kernel"] == "fused_gemm_bwd"
               and r["path"] == "ae"], step, f32_paths),
        entry("conv2d_bn_act", k2, "satae/kernels/conv.py:36", k2_err,
              [r for r in rows if r["kernel"] == "conv2d_bn_act"], chunk,
              f32_paths),
        entry("fused_gemm_bf16", k1, "satae/kernels/matmul.py:36",
              k13["k1_err"], [r for r in rows16 if r["kernel"] ==
                              "fused_gemm_bf16" and r["path"] == "serve"],
              chunk, bf16_paths),
        entry("fused_gemm_bwd_bf16", k1, "satae/kernels/matmul.py:100",
              k13["bwd_err"], [r for r in rows16
                               if r["kernel"] == "fused_gemm_bwd_bf16"],
              step, bf16_paths),
        entry("conv2d_bn_act_bf16", k2, "satae/kernels/conv.py:36",
              k13["k2_err"], [r for r in rows16
                              if r["kernel"] == "conv2d_bn_act_bf16"],
              chunk, bf16_paths)]}
    # the batched K1: per stacked AE step at C = 45 (4 forward, 8 backward
    # launches), launches from the stacked steps, the vmap grids, the
    # 45-config epoch and the CLI
    vmap_paths = {"stacked_steps": [stacked["ae"]["launches"],
                                    stacked["mlp"]["launches"]],
                  "vmap_grid": [vgrid["float32"]["launches"],
                                vgrid["bfloat16"]["launches"]],
                  "full_epoch": [vgrid["full_epoch"]["launches"]],
                  "cli": [vgrid["cli"]["launches"]]}
    vstep = f"one stacked AE step at C = {VMAP_C['ae']}"
    kb = "satae_torch/csrc/fused_gemm.cu"
    for name, replaces in (
            ("fused_gemm_batched", "satae/kernels/matmul.py:36"),
            ("fused_gemm_batched_bwd", "satae/kernels/matmul.py:100")):
        for sfx, dt in (("", "float32"), ("_bf16", "bf16")):
            report["kernels"].append(entry(
                name + sfx, kb, replaces, k21["max_abs_err"][dt],
                [r for r in k21["rows"] if r["kernel"] == name + sfx
                 and r["path"] == "ae"], vstep, vmap_paths))
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
        mlp_parity_other_lr=mlp_other_lr,
        fit=fit_record(fit), bf16_kernels=k13, bf16_serve=serve16,
        bf16_fit=fit_record(fit16), bf16_throughput_fit=fit_record(fit_tp),
        throughput_step_ms={"ae_bf16": tp_ms[torch.bfloat16],
                            "ae_float32": tp_ms[torch.float32],
                            "mlp": mlp_tp_ms, "batch": tb},
        train_rows=train_rows, ae_step_ms=ae_step_ms,
        ae_step_det_ms=ae_step_det_ms, ae_step_ms_in_turns=step_ms,
        det_profile_wall_ms=det_wall, det_profile_device_ms=det_dev,
        det_profile_top=top_ops(det_events, 12),
        mlp_step_ms=mlp_step_ms, train_profile_wall_ms=tr_wall,
        train_profile_device_ms=tr_dev, train_profile_top=tr_top, grid=grid,
        bf16_grid=grid16,
        new_k1_rows=new_rows + [r for r in rows16 if r["path"] == "decode"],
        decode=decode, profiler_check=prof_check,
        device_us_retries=DEVICE_US_RETRIES,
        calibrate=calib, inflight=inflight, cli=cli_res,
        phase_seconds_17_24=phase_s, batched_kernels=k21,
        stacked_steps=stacked, vmap_grid=vgrid, steps_engine=steps_eng,
        mfu=mfu, parallel=par, example=example, **report), indent=1,
        default=str))
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def bf16_serve_phase(card: str, data_cfg, test, f32_ips: float) -> dict:
    """Phase 14: the bf16-trained full-width model served in bf16 on the
    test split: launch counts per dtype, accuracy against satae's own bf16
    serving, the same fold on the plain kernel versions and the plain
    modules (satae's layer-by-layer bf16) on the same card, images/s."""
    import numpy as np
    import torch

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import PipelineConfig, RuntimeConfig
    from satae_torch.data.augment import normalize
    from satae_torch.kernels.conv import conv2d_bn_act_plain
    from satae_torch.kernels.matmul import fused_matmul_plain
    from satae_torch.nn import layers as L

    bf = torch.bfloat16
    cfg = PipelineConfig(data=data_cfg,
                         runtime=RuntimeConfig(compute_dtype="bfloat16"))
    pipe = SatAEPipeline(cfg).load(str(CKPT_BF16))
    n_img = len(test)
    n_chunks = -(-n_img // CHUNK)
    kernels.reset_launch_counts()
    preds = pipe.predict(test.images)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = counts(conv2d_bn_act_bf16=4 * n_chunks, fused_gemm_bf16=n_chunks,
                  fused_gemm=3 * n_chunks)
    check(launches == want, f"bf16 serving launches {launches}, expected "
          f"{want}")
    acc = float((preds == test.labels).mean())
    tpu_acc = json.loads((CKPT_BF16 / "fit_summary.json").read_text())[
        "test_acc"]
    gap = abs(acc - SATAE_BF16_ACC)
    print(f"bf16 predict of {CKPT_BF16.name}: {n_img} test images, accuracy "
          f"{acc:.6f} ({int(round(acc * n_img))} right; satae's own bf16 "
          f"serving {SATAE_BF16_ACC:.6f}, gap {gap:.6f}, band 0.004; "
          f"fit_summary.json {tpu_acc:.6f}, scored on a TPU), launches "
          f"{launches}", flush=True)
    check(gap <= 0.004, f"bf16 accuracy {acc} is {gap} from satae's "
          f"{SATAE_BF16_ACC}")

    z = torch.from_numpy(pipe.encode(test.images))
    check(z.dtype == torch.float32 and tuple(z.shape) == (
        n_img, cfg.model.latent_dim), f"bf16 latents {z.dtype} {z.shape}")
    fe, fm = pipe._folded_weights()
    with torch.no_grad():
        x = normalize(torch.from_numpy(test.images).to(pipe.device), bf)
        # the same fold on the plain versions of K2 and K1
        h = x
        for c in fe.convs:
            h = conv2d_bn_act_plain(h, c.w, c.scale, c.shift, c.stride,
                                    c.padding, "relu")
        p = fe.proj
        kn = lambda lay: lay.w.t() if lay.w_nk else lay.w  # (K, N)
        z_fold = fused_matmul_plain(h.reshape(n_img, -1), kn(p), p.scale,
                                    p.shift, p.act).float()
        logits = z_fold
        for lay in fm.layers:
            logits = fused_matmul_plain(logits, kn(lay), lay.scale,
                                        lay.shift, lay.act)
        preds_fold = torch.argmax(logits, -1).cpu().numpy()
        # the plain modules: satae's bf16 arithmetic layer by layer
        z_mod = pipe.ae.enc(x, L.linear_plain).float()
        preds_mod = torch.argmax(pipe.mlp(z_mod, linear=L.linear_plain),
                                 -1).cpu().numpy()
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    z_fold, z_mod = z_fold.cpu().numpy(), z_mod.cpu().numpy()
    z = z.numpy()
    gap_fold, gap_mod = rel(z, z_fold), rel(z, z_mod)
    agree_fold = float((preds == preds_fold).mean())
    agree_mod = float((preds == preds_mod).mean())
    print(f"bf16 kernels vs the same fold on the plain versions: latents "
          f"{gap_fold:.3g} relative L2 (bound 2^-7), predictions agree "
          f"{agree_fold:.6f} (bound 0.999); vs the plain modules in bf16 "
          f"(BatchNorm in bf16, two roundings per linear): latents "
          f"{gap_mod:.3g}, predictions agree {agree_mod:.6f} (bound 0.99); "
          f"plain modules score {float((preds_mod == test.labels).mean()):.6f}"
          , flush=True)
    check(gap_fold <= 2.0 ** -7, f"bf16 latents {gap_fold} from the plain "
          "fold")
    check(agree_fold >= 0.999, f"bf16 predictions agree {agree_fold} with "
          "the plain fold")
    check(agree_mod >= 0.99, f"bf16 predictions agree {agree_mod} with the "
          "plain modules")

    pipe.predict(test.images)  # warm-up
    predict_ms = time_ms(lambda: pipe.predict(test.images), reps=10,
                         warmup=1)
    ips = n_img / (predict_ms / 1e3)
    print(f"bf16 predict: {ips:.1f} images/s ({predict_ms:.3f} ms per call "
          f"of {n_img} images); float32 (phase 6) {f32_ips:.1f} images/s; "
          f"card {card}", flush=True)
    return dict(launches=launches, accuracy=acc, satae_bf16_accuracy=(
        SATAE_BF16_ACC), recorded_tpu_accuracy=tpu_acc, latent_gap_fold=(
        gap_fold), agree_fold=agree_fold, latent_gap_modules=gap_mod,
        agree_modules=agree_mod, predict_images_per_s=ips,
        predict_ms=predict_ms, f32_images_per_s=f32_ips)


def fit_record(fit: dict) -> dict:
    """:func:`fit_phase`'s result as chip_smoke.json keeps it."""
    return {k: (v.__dict__ if k == "summary" else v) for k, v in fit.items()}


def fit_phase(cfg, raw, splits, what: str, repeat: bool = True,
              recorded_val_loss=None) -> dict:
    """SatAEPipeline(cfg).fit(raw, grid=False) with the launch counts zeroed
    before and read after, held equal to :func:`fit_launches`; losses finite
    and falling, test accuracy above chance, predict after the fit scoring
    the fit's test accuracy, the master state float32; with ``repeat`` the
    same fit again, which must repeat bit for bit. Returns what
    chip_smoke.json keeps, the summary and history too."""
    import torch

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import AETrainConfig, MLPTrainConfig

    mcfg, dcfg, test = cfg.model, cfg.data, splits.test
    print(f"{what}: full width {mcfg.encoder_channels}, latent "
          f"{mcfg.latent_dim}, MLP {mcfg.mlp_hidden}, batch {dcfg.batch_size},"
          f" compute {cfg.runtime.compute_dtype}, synthetic-hard per_class "
          f"{dcfg.per_class}; cut: AE max_epochs {cfg.ae.max_epochs} (of "
          f"{AETrainConfig().max_epochs}), MLP epochs {cfg.mlp.epochs} (of "
          f"{MLPTrainConfig().epochs})", flush=True)
    fitted = SatAEPipeline(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = fitted.fit(raw, grid=False, log=lambda ln: print("  " + ln,
                                                                flush=True))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    hist = fitted.history
    ep_ae, ep_mlp = (len(hist[s]["train_loss"]) for s in ("ae", "mlp"))
    n_split = (len(splits.train), len(splits.val), len(test))
    expected = fit_launches(n_split, dcfg.batch_size, ep_ae, ep_mlp, mcfg,
                            cfg.compute_dtype == torch.bfloat16)
    print(f"{what}: {fit_s:.2f} s, stage_seconds {summary.stage_seconds}; "
          f"{ep_ae} AE + {ep_mlp} MLP epochs of {n_split[0] // dcfg.batch_size}"
          f" steps, splits {n_split}; launches {launches}, expected "
          f"{expected}", flush=True)
    check(launches == expected, f"{what}: launch counts differ from the "
          "steps, eval batches and extraction chunks")
    for stage_, h in hist.items():
        vals = [v for series in h.values() for v in series]
        check(all(math.isfinite(v) for v in vals), f"{what} {stage_}: a loss "
              "is not finite")
        check(h["train_loss"][1] < h["train_loss"][0],
              f"{what} {stage_}: mean train loss did not fall: "
              f"{h['train_loss']}")
    master = [k for mod in (fitted.ae, fitted.mlp)
              for k, v in mod.state_dict().items()
              if v.is_floating_point() and v.dtype != torch.float32]
    check(not master, f"{what}: master state not float32: {master}")
    rec = ("" if recorded_val_loss is None else
           f" (recorded before the bf16 kernels: {recorded_val_loss})")
    print(f"{what}: AE train loss {hist['ae']['train_loss']}, MLP train loss "
          f"{hist['mlp']['train_loss']}, AE best val loss "
          f"{summary.ae_val_loss}{rec}, MLP best val acc "
          f"{summary.mlp_val_acc}, test accuracy {summary.test_acc}; "
          "parameters and BatchNorm stats float32", flush=True)
    check(summary.test_acc > 1.0 / mcfg.num_classes,
          f"{what}: test accuracy {summary.test_acc} is not above chance")
    preds = fitted.predict(test.images)
    pred_acc = float((preds == test.labels).mean())
    check(pred_acc == summary.test_acc, f"{what}: predict after fit scores "
          f"{pred_acc}, fit reported {summary.test_acc}")
    out = dict(fit_s=fit_s, summary=summary, hist=hist, launches=launches,
               expected_launches=expected, predict_acc=pred_acc)
    if not repeat:
        return out
    t0 = time.perf_counter()
    refit = SatAEPipeline(cfg)
    summary_again = refit.fit(raw, grid=False)
    out["refit_s"] = time.perf_counter() - t0
    differ = [k for a, b in ((fitted.ae, refit.ae), (fitted.mlp, refit.mlp))
              for k, v in a.state_dict().items()
              if not torch.equal(v, b.state_dict()[k])]
    print(f"{what} again: {out['refit_s']:.2f} s; tensors that differ from "
          f"the first fit: {len(differ)}", flush=True)
    check(not differ, f"{what}: a second fit differs in {differ}")
    for f in ("ae_val_loss", "mlp_val_acc", "test_acc"):
        check(getattr(summary_again, f) == getattr(summary, f),
              f"{what}: a second fit gives {f} {getattr(summary_again, f)}, "
              f"the first {getattr(summary, f)}")
    return out


def grid_phase(card: str, bf16: bool = False) -> dict:
    """Phase 12: the grid fit of the recorded cross-framework gate, its
    resume, evaluate, save and export; with ``bf16`` (phase 16) the same
    under satae's bf16 recipe, into a run directory of its own. Returns what
    chip_smoke.json keeps; ``launches`` are the first fit's."""
    import numpy as np
    import torch

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.train.extract import extract_chunk

    cfg, gate = gate_config("bfloat16" if bf16 else "float32")
    alphas, ae_lrs = cfg.ae.alphas, cfg.ae.learning_rates
    mlp_lrs = cfg.mlp.learning_rates
    what, sfx = ("bf16 grid", "_bf16") if bf16 else ("grid", "")
    mcfg, bs = cfg.model, cfg.data.batch_size
    raw = load_dataset(cfg.data)
    splits = make_splits(raw, cfg.data)
    test = splits.test
    run = REPO / "chiprun_out" / ("grid_run" + sfx)
    shutil.rmtree(run, ignore_errors=True)
    print(f"{what}: channels {mcfg.encoder_channels}, latent {mcfg.latent_dim}"
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
    print(f"{what}: {fit_s:.2f} s, stage_seconds {st}; seconds per AE config "
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
    n_lin_mlp = len(mcfg.mlp_hidden) + 1
    expected = fit_launches((n_tr, n_va, n_te), bs,
                            n_ae * cfg.ae.max_epochs, n_lr * e_mlp, mcfg,
                            bf16, n_lr, test_b)
    print(f"{what}: {n_ae} AE configs x {cfg.ae.max_epochs} epochs and {n_lr} "
          f"MLP lrs x {e_mlp} epochs of {steps} steps, {val_b} val batches, "
          f"{test_b} test batches, {chunks} extraction chunks; launches "
          f"{launches}, expected {expected}", flush=True)
    check(launches == expected, f"{what} launch counts differ from the configs,"
          " steps, eval batches and extraction chunks")

    # the outcome against satae's run of the same gate on the same arrays:
    # its recorded float32 run, or for bf16 its own bf16 run
    # (scripts/satae_gate_reference.py), within the gate's band either way;
    # the bf16 run's gap to the recorded float32 one is printed beside
    f32_rec = gate["satae"]
    rec = (json.loads(SATAE_GATE_BF16.read_text())["satae"] if bf16
           else f32_rec)
    acc_gap = abs(summary.test_acc - rec["test_acc"])
    band = gate["band"]
    print(f"{what}: winners AE {summary.ae_hparams} (satae "
          f"{rec['ae_hparams']}), MLP {summary.mlp_hparams} (satae "
          f"{rec['mlp_hparams']}); AE best val loss {summary.ae_val_loss} "
          f"(satae {rec['ae_best_val_loss']}), MLP best val acc "
          f"{summary.mlp_val_acc} (satae {rec['mlp_best_val_acc']}), test "
          f"accuracy {summary.test_acc} (satae {rec['test_acc']}, gap "
          f"{acc_gap:.4f}, band {band:.4f}"
          + (f"; satae's recorded float32 {f32_rec['test_acc']}, gap "
             f"{abs(summary.test_acc - f32_rec['test_acc']):.4f}" if bf16
             else f"; recorded before the bf16 kernels: "
             f"{RECORDED_GRID_TEST_ACC}") + "); per-lr test accuracy "
          f"{[r['test_acc'] for r in mlp_store.values()]}", flush=True)
    if bf16:
        check(summary.ae_hparams == rec["ae_hparams"]
              and summary.mlp_hparams == rec["mlp_hparams"],
              f"{what}: winners {summary.ae_hparams} {summary.mlp_hparams}, "
              f"satae's {rec['ae_hparams']} {rec['mlp_hparams']}")
    check(acc_gap <= band, f"{what}: test accuracy {summary.test_acc} is "
          f"{acc_gap:.4f} from satae's {rec['test_acc']}")
    preds = pipe.predict(test.images)
    check(float((preds == test.labels).mean()) == summary.test_acc,
          "predict after the grid fit disagrees with its test accuracy")

    # a second fit on the same run directory trains nothing
    again = SatAEPipeline(cfg)
    summary2, resume_s, _, lines2, launches2 = timed_fit(again)
    # extraction of the three splits and the winner's test evaluation
    expected2 = counts(fused_gemm=n_lin_mlp)
    expected2["fused_gemm" + sfx] += chunks
    expected2["conv2d_bn_act" + sfx] += chunks * len(mcfg.encoder_channels)
    print(f"{what} resume: {resume_s:.2f} s, {len(lines2)} log lines, "
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
    print(f"{what}: load + evaluate accuracy {float(ev['accuracy']):.6f} = "
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
                recorded=rec, test_acc_gap=acc_gap, band=band,
                resume_s=resume_s,
                resume_launches=launches2,
                resume_stage_seconds=summary2.stage_seconds,
                evaluate_accuracy=float(ev["accuracy"]),
                confusion_matrix=ev["confusion_matrix"].tolist(), card=card)


INFLIGHT_CHILD = r"""
import json, sys
from satae_torch import kernels
from satae_torch.api import SatAEPipeline
from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                PipelineConfig)
out, cache = sys.argv[1], sys.argv[2]
cfg = PipelineConfig(
    data=DataConfig(per_class=256, synthetic_difficulty="hard",
                    cache_dir=cache),
    ae=AETrainConfig(max_epochs=4, checkpoint_every=1),
    mlp=MLPTrainConfig(epochs=2))
kernels.reset_launch_counts()
s = SatAEPipeline(cfg).fit(out_dir=out, log=lambda ln: print(ln, flush=True))
print("RESULT " + json.dumps(dict(summary=s.__dict__,
                                  launches=kernels.launch_counts())),
      flush=True)
"""


def decode_phase(card: str, data_cfg, test) -> dict:
    """Phase 17: reconstruct_batched and decode of the committed float32 and
    bf16 models over the test split, on the kernels: exact launches, x_hat
    against the plain modules on the card, the mean MSE against satae's on
    the CPU, images/s."""
    import numpy as np
    import torch

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import PipelineConfig, RuntimeConfig
    from satae_torch.data.augment import normalize
    from satae_torch.nn import layers as L

    ref = json.loads(SATAE_SERVING_REF.read_text())
    n_img = len(test)
    n_chunks = -(-n_img // CHUNK)
    x_u8 = torch.from_numpy(test.images)
    out = {}
    for dtype, ckpt in (("float32", CKPT), ("bfloat16", CKPT_BF16)):
        sfx = "_bf16" if dtype == "bfloat16" else ""
        dt = getattr(torch, dtype)
        cfg = PipelineConfig(data=data_cfg,
                             runtime=RuntimeConfig(compute_dtype=dtype))
        pipe = SatAEPipeline(cfg).load(str(ckpt))
        kernels.reset_launch_counts()
        rec = pipe.reconstruct_batched(test.images)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = counts(**{"conv2d_bn_act" + sfx: 4 * n_chunks,
                         "fused_gemm" + sfx: 2 * n_chunks})
        check(launches == want, f"{dtype} reconstruct launches {launches}, "
              f"expected {want}")
        check(rec.shape == (n_img, 64, 64, 3) and rec.dtype == np.float32
              and bool(np.isfinite(rec).all()), f"{dtype} reconstructions "
              f"{rec.shape} {rec.dtype}")
        z = pipe.encode(test.images)
        kernels.reset_launch_counts()
        dec = pipe.decode(z)
        torch.cuda.synchronize()
        dec_launches = kernels.launch_counts()
        check(dec_launches == counts(**{"fused_gemm" + sfx: n_chunks}),
              f"{dtype} decode launches {dec_launches}")
        # the same inputs again: the decoder's convolutions must repeat bit
        # for bit (satae's XLA decoder does)
        again = {"reconstruct": (rec, pipe.reconstruct_batched(test.images)),
                 "decode": (dec, pipe.decode(z))}
        repeat = {k: float(np.abs(b - a).max()) for k, (a, b) in again.items()}
        print(f"{dtype}: reconstruct_batched and decode called again on the "
              f"same inputs, max |diff| to the first calls {repeat}",
              flush=True)
        check(all(v == 0.0 for v in repeat.values()),
              f"{dtype}: the decoder does not repeat bit for bit: {repeat}")
        # the same computation on the same chunks, cuDNN's deterministic
        # algorithms in both
        dec_gap = float(np.abs(dec - rec).max())
        check(dec_gap == 0.0,
              f"{dtype}: decode(encode(x)) is {dec_gap} from reconstruct(x)")
        # the modules on stock PyTorch ops, TF32 off
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad(), L.float32_convs():
                x = normalize(x_u8.to(pipe.device), dt)
                z_p = pipe.ae.enc(x, L.linear_plain).float()
                rec_p = pipe.ae.dec(z_p.to(dt), L.linear_plain).float()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        rec_p = rec_p.cpu().numpy()
        diff = float(np.abs(rec - rec_p).max())
        rel_l2 = float(np.linalg.norm(rec - rec_p) / np.linalg.norm(rec_p))
        mse = float(np.mean(np.mean(np.square(
            rec - test.images.astype(np.float32) / 255.0), axis=(1, 2, 3))))
        r = ref[f"reconstruct_{dtype}"]
        rel = abs(mse - r["satae_mean_mse"]) / r["satae_mean_mse"]
        pipe.reconstruct_batched(test.images)  # warm-up
        rec_ms = time_ms(lambda: pipe.reconstruct_batched(test.images),
                         reps=10, warmup=1)
        ips = n_img / (rec_ms / 1e3)
        print(f"reconstruct_batched {dtype} ({ckpt.name}): {n_img} images, "
              f"launches {launches}, decode {dec_launches}; x_hat vs the "
              f"plain modules max |diff| {diff:.3g} (bound "
              f"{RECON_ATOL[dtype]:g}), relative L2 {rel_l2:.3g} (bound "
              f"{RECON_REL_L2[dtype]:g}); mean MSE {mse!r} (satae on the CPU "
              f"{r['satae_mean_mse']!r}, relative gap {rel:.3g}, bound "
              f"{RECON_MSE_RTOL[dtype]:g}); decode(encode(x)) max |diff| "
              f"{dec_gap:.3g}; {ips:.1f} images/s ({rec_ms:.3f} "
              f"ms per call); card {card}", flush=True)
        check(diff <= RECON_ATOL[dtype] and rel_l2 <= RECON_REL_L2[dtype],
              f"{dtype} reconstructions differ from the plain modules by "
              f"{diff} (relative L2 {rel_l2})")
        check(rel <= RECON_MSE_RTOL[dtype], f"{dtype} mean MSE {mse} vs "
              f"satae's {r['satae_mean_mse']}")
        out[dtype] = dict(launches=launches, decode_launches=dec_launches,
                          decode_gap=dec_gap, repeat_max_abs=repeat,
                          max_abs_diff_plain=diff, rel_l2_plain=rel_l2,
                          mean_mse=mse,
                          satae_mean_mse=r["satae_mean_mse"], mse_rel_gap=rel,
                          images_per_s=ips, reconstruct_ms=rec_ms)
    return out


def init_band(ref: dict) -> dict:
    """For each of median, p5 and p95: three standard errors of the
    difference of two runs of the experiment on one augmented batch with
    independent inits, each with satae's bootstrap standard error."""
    se = ref["calibration"]["bootstrap_se"]
    return {k: 3.0 * math.sqrt(2.0) * se[k] for k in ("median", "p5", "p95")}


def calibrate_band(ref: dict) -> dict:
    """Phase 18's band for the card's own run against satae's: the
    :func:`init_band`, plus the spread the port's own CPU calibration shows
    across augmentation seeds (one augmented batch moves every ratio of a
    run together, and the card draws another batch than either CPU run)."""
    by_seed = ref["calibration"]["port_cpu_by_seed"].values()
    return {k: v + (max(s[k] for s in by_seed) - min(s[k] for s in by_seed))
            for k, v in init_band(ref).items()}


def calibrate_phase(card: str, splits, data_cfg) -> dict:
    """Phase 18: satae's CLI calibration (latent 128, 1,000 inits, the first
    shuffled batch of 64 of the train split, seed 0) on the card: 4 K1
    launches per init exactly, median / p5 / p95 within the band of satae's
    CPU run."""
    import numpy as np
    import torch

    from satae_torch import kernels
    from satae_torch.config import ModelConfig
    from satae_torch.data.augment import augment_train_batch
    from satae_torch.data.pipeline import iter_batches
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn.init import init_
    from satae_torch.train.calibrate import (CalibrationSummary, init_ratio,
                                             loss_ratio_calibration)

    ref = json.loads(SATAE_SERVING_REF.read_text())
    cal, band = ref["calibration"], calibrate_band(ref)
    imgs, labels = next(iter_batches(splits.train, data_cfg.batch_size,
                                     shuffle=True, seed=0))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ratios = loss_ratio_calibration(imgs, labels, data_cfg=data_cfg,
                                    n_inits=cal["n_inits"], seed=0)
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(launches == counts(fused_gemm=4 * cal["n_inits"]),
          f"calibration launches {launches}")
    check(bool(np.isfinite(ratios).all()), "a calibration ratio is not finite")
    s = CalibrationSummary.from_ratios(ratios)
    gaps = {k: abs(getattr(s, k) - cal["satae"][k]) for k in band}
    print(f"calibrate: {cal['n_inits']} inits at latent 128 in {wall_s:.2f} s "
          f"({wall_s / cal['n_inits'] * 1e3:.3f} ms per init), launches "
          f"{launches}; median {s.median:.4f} p5 {s.p5:.4f} p95 {s.p95:.4f} "
          f"mean {s.mean:.4f}; satae on the CPU " + ", ".join(
              f"{k} {cal['satae'][k]:.4f} (gap {gaps[k]:.4f}, band "
              f"{band[k]:.4f})" for k in band) + f"; card {card}", flush=True)
    # the batch augmented on the CPU and inits drawn there, as
    # loss_ratio_calibration(seed=0, device="cpu") makes them: the first
    # CAL_CARRIED on both sides, then the card's own 1,000 inits on it
    dev = torch.device("cuda")
    base = 1 << 32  # (seed + 1) << 32
    x_cpu = augment_train_batch(
        torch.from_numpy(imgs), crop_padding=data_cfg.crop_padding,
        noise_std=data_cfg.noise_std,
        generator=torch.Generator().manual_seed(0))
    y_cpu = torch.from_numpy(np.asarray(labels)).long()
    x_dev, y_dev = x_cpu.to(dev), y_cpu.to(dev)
    model = SupervisedAE(ModelConfig(latent_dim=128), x_cpu.shape[-1],
                         x_cpu.shape[1])
    carried = []
    for i in range(CAL_CARRIED):
        init_(model.cpu(), torch.Generator().manual_seed(base + i))
        on_cpu = float(init_ratio(model, x_cpu, y_cpu))
        carried.append((on_cpu, float(init_ratio(model.to(dev), x_dev,
                                                 y_dev))))
    carried_rel = max(abs(c - p) / abs(p) for p, c in carried)
    print(f"calibrate: {CAL_CARRIED} inits and the augmented batch made on "
          f"the CPU, ratios on the card vs the plain versions on the CPU: "
          f"max relative gap {carried_rel:.3g} (bound {CAL_RTOL:g}); "
          f"{[c for _, c in carried]}", flush=True)
    fixed = torch.empty(cal["n_inits"], device=dev)
    for i in range(cal["n_inits"]):
        init_(model, torch.Generator(device=dev).manual_seed(base + i))
        fixed[i] = init_ratio(model, x_dev, y_dev)
    sf = CalibrationSummary.from_ratios(fixed.cpu().numpy())
    init_(model, torch.Generator(device=dev).manual_seed(base))
    again = [init_ratio(model, x_dev, y_dev) for _ in range(2)]
    repeats = bool(torch.equal(*again))
    print(f"calibrate: init_ratio of one init twice on the card: "
          f"{[float(r) for r in again]!r}, bitwise equal {repeats}",
          flush=True)
    check(repeats, f"init_ratio does not repeat bit for bit: {again}")
    port0, fband = cal["port_cpu_by_seed"]["0"], init_band(ref)
    fgaps = {k: abs(getattr(sf, k) - port0[k]) for k in fband}
    print(f"calibrate: the card's {cal['n_inits']} inits on the CPU's "
          f"augmented batch: " + ", ".join(
              f"{k} {getattr(sf, k):.4f} (the port on the CPU {port0[k]:.4f},"
              f" gap {fgaps[k]:.4f}, band {fband[k]:.4f})" for k in fband)
          + f"; the card's own batch moves the median by "
          f"{s.median - sf.median:+.4f}", flush=True)
    check(carried_rel <= CAL_RTOL, f"calibration ratios on the card differ "
          f"from the CPU's on the same inits and batch: {carried}")
    for k in fband:
        check(fgaps[k] <= fband[k], f"calibration {k} on the CPU's batch "
              f"{getattr(sf, k)} is {fgaps[k]} from the port's CPU run "
              f"{port0[k]} (band {fband[k]})")
    for k in band:
        check(gaps[k] <= band[k], f"calibration {k} {getattr(s, k)} is "
              f"{gaps[k]} from satae's {cal['satae'][k]} (band {band[k]})")
    return dict(launches=launches, wall_s=wall_s,
                summary=dataclasses.asdict(s), satae=cal["satae"], band=band,
                gaps=gaps, carried=carried, carried_max_rel=carried_rel,
                cpu_batch_summary=dataclasses.asdict(sf),
                cpu_batch_port=port0, cpu_batch_band=fband,
                cpu_batch_gaps=fgaps, init_ratio_repeats=repeats)


def inflight_phase(card: str) -> dict:
    """Phase 19: a full-width fit(out_dir, checkpoint_every=1) in a process
    of its own, killed with SIGKILL once its in-flight state records epoch
    >= 1 and run again: the rerun resumes, launches K1's backward only for
    the epochs after the resume, ends where an uninterrupted run ends, bit
    for bit, and leaves inflight/ empty."""
    import signal

    from satae_torch.config import (DataConfig, MLPTrainConfig,
                                    PipelineConfig)
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits

    base = REPO / "chiprun_out"
    run, ref_run = base / "inflight_run", base / "inflight_ref"
    cache = base / "inflight_cache"
    for d in (run, ref_run):
        shutil.rmtree(d, ignore_errors=True)
    child = lambda out: subprocess.Popen(
        [sys.executable, "-c", INFLIGHT_CHILD, str(out), str(cache)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO))

    def result(proc, what):
        text, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"{what} failed:\n{text[-3000:]}")
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        check(len(line) == 1, f"{what} printed no result:\n{text[-3000:]}")
        return text, json.loads(line[0][len("RESULT "):])

    t0 = time.perf_counter()
    ref_text, ref = result(child(ref_run), "the uninterrupted run")
    ref_s = time.perf_counter() - t0
    state = run / "inflight" / "ae_single.state.json"
    proc, killed_at = child(run), None
    t0 = time.perf_counter()
    while proc.poll() is None and time.perf_counter() - t0 < 600:
        try:
            epoch = json.loads(state.read_text())["epoch"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            epoch = -1
        if epoch >= 1:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            killed_at = epoch
            break
        time.sleep(0.01)
    check(killed_at is not None, "the run ended before its in-flight state "
          "recorded epoch 1, or never got there")
    t0 = time.perf_counter()
    text, res = result(child(run), "the resumed run")
    resume_s = time.perf_counter() - t0
    resumed = [ln for ln in text.splitlines() if ln.startswith("resumed from")]
    check(len(resumed) == 1, f"the rerun did not resume:\n{text[-3000:]}")
    start = int(resumed[0].rsplit("epoch", 1)[1])
    check(start >= killed_at + 1, f"resumed at epoch {start}, the kill came "
          f"after epoch {killed_at} was flushed")
    cfg = PipelineConfig(data=DataConfig(per_class=256,
                                         synthetic_difficulty="hard"),
                         mlp=MLPTrainConfig(epochs=2))
    splits = make_splits(load_dataset(cfg.data), cfg.data)
    n_split = (len(splits.train), len(splits.val), len(splits.test))
    want = fit_launches(n_split, BATCH, 4 - start, 2, cfg.model, False)
    ref_want = fit_launches(n_split, BATCH, 4, 2, cfg.model, False)
    check(ref["launches"] == ref_want, f"uninterrupted run launches "
          f"{ref['launches']}, expected {ref_want}")
    check(res["launches"] == want, f"resumed run launches {res['launches']},"
          f" expected {want} (AE epochs {start}-3 only)")
    fields = ("ae_val_loss", "ae_hparams", "mlp_val_acc", "mlp_hparams",
              "test_acc")
    differ = [f for f in fields if res["summary"][f] != ref["summary"][f]]
    left = list((run / "inflight").iterdir())
    print(f"in-flight resume: SIGKILL after epoch {killed_at} was flushed, "
          f"rerun resumed at epoch {start} ({resume_s:.2f} s; the "
          f"uninterrupted run {ref_s:.2f} s); launches {res['launches']} "
          f"(expected {want}); summary {res['summary']} vs uninterrupted "
          f"{ref['summary']}, fields that differ {differ}; inflight/ holds "
          f"{[p.name for p in left]}; card {card}", flush=True)
    check(not differ, f"the resumed fit differs in {differ}")
    check(not left, f"inflight/ not empty: {left}")
    for d in (run, ref_run, cache):
        shutil.rmtree(d, ignore_errors=True)
    return dict(killed_after_epoch=killed_at, resumed_at=start,
                launches=res["launches"], expected_launches=want,
                summary=res["summary"], reference_summary=ref["summary"],
                resume_s=resume_s, reference_s=ref_s)


def cli_phase(card: str) -> dict:
    """Phase 20: satae_torch.cli.main in this process: fit (1 + 1 epochs,
    per_class 256, --ckpt-every 1), calibrate --n-inits 50 (its histogram,
    which satae draws whenever --out is set, only with matplotlib), extract
    and export-torch, each with its artifacts and launches; the subcommands
    that draw figures or decode image files are not run here."""
    import contextlib
    import importlib.util
    import io

    from satae_torch import cli, kernels
    from satae_torch.io import native_loader

    run, cache = REPO / "chiprun_out" / "cli_run", \
        REPO / "chiprun_out" / "cli_cache"
    shutil.rmtree(run, ignore_errors=True)
    common = ["--per-class", "256", "--synthetic-difficulty", "hard",
              "--seed", "0", "--out", str(run), "--cache-dir", str(cache)]
    plots = importlib.util.find_spec("matplotlib") is not None
    res = {}

    def sub(name, argv):
        stdout = io.StringIO()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            cli.main([name] + argv + common)
        res[name] = dict(seconds=time.perf_counter() - t0,
                         launches=kernels.launch_counts())
        return stdout.getvalue()

    fit_out = sub("fit", ["--ae-epochs", "1", "--mlp-epochs", "1",
                          "--ckpt-every", "1"])
    summary = json.loads(fit_out[fit_out.index("{\n"):])
    want = {"ae_global_best.json", "ae_global_best.msgpack", "classes.json",
            "fit_summary.json", "metrics.jsonl", "mlp_global_best.json",
            "mlp_global_best.msgpack", "mlp_provenance.json", "inflight"}
    figures = {"ae_best_curves.png", "mlp_best_curves.png"}
    names = {p.name for p in run.iterdir()}
    check(names == (want | figures if plots else want), f"fit wrote {names}")
    check(not list((run / "inflight").iterdir()), "fit left in-flight files")
    check(list(summary) == ["ae_val_loss", "ae_hparams", "mlp_val_acc",
                            "mlp_hparams", "test_acc", "stage_seconds"],
          f"fit's JSON keys {list(summary)}")
    if not plots:
        log = (run / "metrics.jsonl").read_text()
        check(all(f"{f} not written" in log for f in figures),
              "fit did not log the figures it could not write")
    cal_out = sub("calibrate", ["--n-inits", "50"])
    check(list(json.loads(cal_out)) == ["median", "mean", "p5", "p95"],
          f"calibrate printed {cal_out}")
    check((run / "calibration.json").exists() and (
        run / "ratio_histogram.png").exists() == plots,
        "calibrate's artifacts")
    sub("extract", [])
    for split in ("train", "val", "test"):
        check((run / f"latents_{split}.npz").exists(), f"no {split} latents")
    sub("export-torch", [])
    check(all((run / n).exists() for n in ("AE_GLOBAL_BEST.pt",
                                           "MLP_GLOBAL_BEST.pt")),
          "export-torch wrote no .pt files")
    lc = {k: v["launches"] for k, v in res.items()}
    check(all(lc["fit"][k] > 0 for k in ("fused_gemm", "fused_gemm_bwd",
                                          "conv2d_bn_act")),
          f"fit launches {lc['fit']}")
    check(lc["calibrate"] == counts(fused_gemm=200),
          f"calibrate launches {lc['calibrate']}")
    check(lc["extract"]["conv2d_bn_act"] > 0 and lc["extract"][
        "fused_gemm"] > 0, f"extract launches {lc['extract']}")
    has = dict(matplotlib=plots,
               PIL=importlib.util.find_spec("PIL") is not None,
               jpeglib_h=Path("/usr/include/jpeglib.h").exists(),
               gpp=shutil.which("g++") is not None,
               native_loader=native_loader.native_available())
    print("cli: " + "; ".join(
        f"{k} {v['seconds']:.2f} s, launches "
        f"{ {n: c for n, c in v['launches'].items() if c} }"
        for k, v in res.items()) + f"; fit test accuracy "
        f"{summary['test_acc']}; card {card}", flush=True)
    print("cli: not run on the card: evaluate and report (they draw "
          "figures; matplotlib "
          f"{'present' if plots else 'absent'}), predict and reconstruct "
          "(they decode image files and reconstruct writes PNGs); on this "
          f"machine: {has}", flush=True)
    shutil.rmtree(run)
    shutil.rmtree(cache, ignore_errors=True)
    return dict(subcommands=res, fit_summary=summary, machine=has)


# ---- phases 21-24: the config-batched (vmap) and per-batch sweep engines --

# configs of the vmap path: the default AE grid (5 alphas x 9 lrs) and MLP
# lrs (11)
VMAP_C = {"ae": 45, "mlp": 11}
# (path, layer, batch, in, out, act) of each linear layer of a stacked step
VMAP_LINEARS = (("ae", "proj", BATCH, 4096, 64, "none"),
                ("ae", "dec_in", BATCH, 64, 4096, "none"),
                ("ae", "fc1", BATCH, 64, 128, "relu"),
                ("ae", "fc2", BATCH, 128, 10, "none"),
                ("mlp", "fc0", BATCH, 64, 128, "none"),
                ("mlp", "fc1", BATCH, 128, 64, "none"),
                ("mlp", "fc2", BATCH, 64, 10, "none"))
# satae's own vmap grid of the pc256 gate on a CPU, phase 23's reference
# (scripts/satae_gate_reference_vmap.py writes it)
SATAE_GATE_VMAP = REPO / "scripts" / "satae_pc256_gate_vmap_float32.json"


def batched_products():
    """(path, layer, product, (m, k, n), trans_a, trans_b, act) of every
    batched K1 launch of a stacked step: forward x @ W^T with the (out, in)
    weight read in place, dX = g @ W, dW = g^T @ x."""
    for path, layer, b, i, o, act in VMAP_LINEARS:
        yield path, layer, "fwd", (b, i, o), False, True, act
        yield path, layer, "dX", (b, o, i), False, False, "none"
        yield path, layer, "dW", (o, b, i), True, False, "none"


def gate_config(dtype: str = "float32", parallel: bool = False):
    """The pc256 cross-framework gate's PipelineConfig
    (benchmarks/torch_parity_pc256) and the gate record."""
    from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                    PipelineConfig, RuntimeConfig)

    gate = json.loads((REPO / "benchmarks" / "torch_parity_pc256" /
                       "torch_pipeline_parity.json").read_text())
    cfg = PipelineConfig(
        data=DataConfig(per_class=gate["per_class"],
                        synthetic_difficulty="hard"),
        ae=AETrainConfig(alphas=tuple(gate["ae_grid"]["alphas"]),
                         learning_rates=tuple(gate["ae_grid"]["lrs"]),
                         max_epochs=gate["ae_epochs"],
                         patience=gate["ae_epochs"]),
        mlp=MLPTrainConfig(learning_rates=tuple(gate["mlp_lrs"]),
                           epochs=gate["mlp_epochs"]),
        runtime=RuntimeConfig(seed=gate["seed"], compute_dtype=dtype,
                              parallel_configs=parallel))
    return cfg, gate


def batched_route(dtype, layer: str, product: str) -> str:
    """The loader a batched K1 launch of :func:`batched_products` must run
    on, float32 or bf16: the wgmma kernel ("tma") for every launch but
    fc2's dX and dW, whose 10-wide cotangent rows (20 bytes in bf16, 40 in
    float32) TMA cannot read; the mma.sync loop ("cp.async") for those,
    and in float32 also for the launches --ab timed faster on it: fc2's
    forward (N = 10) and the AE's 4096-wide dX and dW (an MN-major B)."""
    import torch

    tma = not (layer == "fc2" and product in ("dX", "dW"))
    if dtype == torch.float32:
        tma = tma and not (layer == "fc2" or (
            layer in ("proj", "dec_in") and product in ("dX", "dW")))
    return "tma" if tma else "cp.async"


def batched_kernels_phase(card: str) -> dict:
    """Phase 21: the batched K1 (float32 and bf16) at every launch of the
    stacked AE (C = 45) and MLP (C = 11) steps against its plain version on
    the card (TF32 off), on the route :func:`batched_route` names; each
    config's slice against the unbatched K1 on it bit for bit wherever that
    call takes the same plan on the same route; repeats bitwise; each timed
    beside C unbatched launches, torch.bmm and its bound."""
    import torch

    from satae_torch.kernels.matmul import (fused_gemm, fused_matmul_plain,
                                            k1_loader, split_k_plan,
                                            split_k_plan_tma)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    rows, errs = [], {"float32": 0.0, "bf16": 0.0}
    min_equal, same_plan = 1.0, {"cp.async": 0, "tma": 0}
    print(f"phase 21, batched K1 (card {card}): route, device us per launch, "
          "C unbatched launches of the same work, torch.bmm, bound",
          flush=True)
    for dt in (torch.float32, torch.bfloat16):
        name16 = "bf16" if dt == torch.bfloat16 else "float32"
        for path, layer, prod, (m, k, n), ta, tb, act in batched_products():
            c = VMAP_C[path]
            a = torch.randn(c, *((k, m) if ta else (m, k)), device=dev,
                            generator=g).to(dt)
            b = ((torch.rand(c, *((n, k) if tb else (k, n)), device=dev,
                             generator=g) * 2 - 1) / k ** 0.5).to(dt)
            shift = torch.randn(c, n, device=dev, generator=g) * 0.3 \
                if prod == "fwd" else None
            what = f"batched K1 {name16} {path} {layer} {prod} C={c} " \
                f"{(m, k, n)}"
            run = lambda: fused_gemm(a, b, None, shift, act, ta, tb)
            out = run()
            zeros = torch.zeros(n, device=dev)

            def plain():
                return torch.stack([fused_matmul_plain(
                    a[i].t() if ta else a[i], b[i].t() if tb else b[i], None,
                    zeros if shift is None else shift[i], act)
                    for i in range(c)])
            ref = plain()
            if dt == torch.float32:
                err, equal = max_err(out, ref, what), None
            else:
                err, equal = ulp_err(out, ref, what)
                min_equal = min(min_equal, equal)
            errs[name16] = max(errs[name16], err)
            check(all(torch.equal(out, run()) for _ in range(2)),
                  f"{what}: repeated launches differ bitwise")
            route = k1_loader(a, b, ta, tb)
            check(route == batched_route(dt, layer, prod), f"{what}: runs on "
                  f"{route}, expected {batched_route(dt, layer, prod)}")
            planner = functools.partial(split_k_plan_tma, dtype=dt) \
                if route == "tma" else split_k_plan
            plan = planner(m, n, k, batch=c)
            # the unbatched call runs the same kernel with C = 1 where it
            # takes the same plan on the same route: bitwise the same slice
            natural = (planner(m, n, k) == plan
                       and k1_loader(a[0], b[0], ta, tb) == route)
            same_plan[route] += natural
            for i in range(c if natural else 0):
                one = fused_gemm(a[i], b[i], None,
                                 None if shift is None else shift[i], act,
                                 ta, tb)
                check(torch.equal(one, out[i]), f"{what}: config {i} differs "
                      f"from the unbatched K1 with plan {plan} on {route}")
            esize = a.element_size()
            nbytes = esize * c * (m * k + k * n + m * n) + (
                0 if shift is None else 4 * c * n)
            bd = bounds(2.0 * c * m * n * k, nbytes,
                        bf16=dt == torch.bfloat16)
            bound_us = bd["bound_ms"] * 1e3
            A = a.transpose(1, 2) if ta else a
            B = b.transpose(1, 2) if tb else b
            unbatched = lambda: [fused_gemm(
                a[i], b[i], None, None if shift is None else shift[i], act,
                ta, tb) for i in range(c)]
            lib = lambda: torch.bmm(A, B)
            row = dict(
                kernel="fused_gemm_batched" + ("" if prod == "fwd"
                                               else "_bwd")
                + ("_bf16" if dt == torch.bfloat16 else ""),
                path=path, layer=layer, product=prod, shape=[c, m, k, n],
                trans_a=ta, trans_b=tb, route=route, plan=list(plan),
                same_plan_as_unbatched=natural, max_abs_err=err,
                bit_equal=equal,
                device_us=device_us(run, bound_us, what),
                unbatched_device_us=device_us(unbatched, bound_us,
                                              what + " x C unbatched"),
                library_device_us=device_us(lib, bound_us / 2,
                                            what + " torch.bmm"),
                ms=time_ms(run), plain_ms=time_ms(plain, 5, 1),
                library_ms=time_ms(lib), **bd)
            rows.append(row)
            print(f"  {name16:7s} {path:3s} {layer:6s} {prod:3s} C={c:2d} "
                  f"{m:4d}x{k:4d}x{n:4d} {route:8s} plan {plan[1:]}: "
                  f"{row['device_us']:8.1f} us | {c} unbatched "
                  f"{row['unbatched_device_us']:8.1f} us | bmm "
                  f"{row['library_device_us']:8.1f} us | bound "
                  f"{bound_us:6.1f} us ({bd['bound_by']}); max |err| "
                  f"{err:.3g}" + ("" if equal is None else
                                  f", bit-equal {equal:.5f}"), flush=True)
    on_tma = sum(r["route"] == "tma" for r in rows)
    print(f"phase 21: {len(rows)} cases, float32 max |err| "
          f"{errs['float32']:.3g} (1e-4 + 1e-5*|ref|), bf16 max |err| "
          f"{errs['bf16']:.3g} (one ulp + 1e-6), bf16 bit-equal >= "
          f"{min_equal:.5f}; {on_tma} launches on wgmma, the rest on "
          "mma.sync (fc2 dX / dW; in float32 also fc2 fwd and the AE's "
          "4096-wide dX / dW); every config's slice "
          "bit-equal to the unbatched K1 in the cases where it takes the "
          f"batched plan on the same route (mma.sync {same_plan['cp.async']},"
          f" wgmma {same_plan['tma']}); 3 launches per case bitwise equal",
          flush=True)
    return dict(rows=rows, max_abs_err=errs, min_bit_equal=min_equal,
                same_plan_cases=same_plan, card=card)


def stacked_steps_phase(card: str, splits, k21_rows) -> dict:
    """Phase 22: 10 stacked AE steps (C = 45, the default grid's alphas, lr
    1e-5) and 10 stacked MLP steps (C = 11) at full width, batch 64, TF32
    off, deterministic cuDNN, against each config's single-config steps on
    stock PyTorch linears from the same weights and draws, as phase 9 holds
    its runs; exact batched K1 launches per stacked step; the stacked AE
    step's time in turns with 45 single-config steps, its device-busy
    share and peak memory; then the stacked AE step in bf16 (satae's
    recipe) in turns with float32, and the batched K1's device share of
    each: the device us of phase 21's AE rows (``k21_rows``: the step's 4 +
    8 launches) over the step's ms. Printed, not held."""
    import torch

    from satae_torch import kernels
    from satae_torch.config import AETrainConfig, DataConfig, ModelConfig
    from satae_torch.models.mlp import MLP
    from satae_torch.models.stacked import StackedMLP, StackedSupervisedAE
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn import layers as L
    from satae_torch.train.optim import adam_init
    from satae_torch.train.steps import (ae_train_step, mlp_train_step,
                                         stacked_ae_train_step,
                                         stacked_mlp_train_step)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    mcfg, dcfg, grid = ModelConfig(), DataConfig(), AETrainConfig()
    lr, steps = 1e-5, PARITY_STEPS
    alphas = [a for a in grid.alphas for _ in grid.learning_rates]
    c_ae, c_mlp = len(alphas), VMAP_C["mlp"]
    imgs_tr = torch.from_numpy(splits.train.images).to(dev)
    labs_tr = torch.from_numpy(splits.train.labels).to(dev).long()
    out = {}

    def run(stacked, singles, make_batch, stacked_step, single_step, what,
            want):
        """The stacked run and each config's single-config run (plain
        linears) from the same weights; per-config loss gaps and final
        state against phase 9's bounds."""
        c = stacked.n_configs
        init = [stacked.config(i) for i in range(c)]
        pairs = pre_bn_biases(singles[0])
        opt = adam_init(list(stacked.parameters()))
        share = {bn: 0.0 for _, bn in pairs}
        batches = [make_batch() for _ in range(steps)]
        loss_s = []
        kernels.reset_launch_counts()
        for batch in batches:
            sd = stacked.state_dict()
            for b_name, bn in pairs:
                share[bn] = 0.9 * share[bn] + 0.1 * sd[b_name]
            metrics, _ = stacked_step(stacked, opt, batch)
            loss_s.append(metrics["loss"].tolist())
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check(launches == want, f"{what}: launches {launches}, expected "
              f"{want}")
        worst_gap, worst = 0.0, {}
        for i in range(c):
            model = singles[i]
            model.load_state_dict(init[i])
            ref_model = copy.deepcopy(model)
            sopt = adam_init(list(model.parameters()))
            share_i = {bn: 0.0 for _, bn in pairs}
            loss_i = []
            for batch in batches:
                sd = model.state_dict()
                for b_name, bn in pairs:
                    share_i[bn] = 0.9 * share_i[bn] + 0.1 * sd[b_name]
                metrics, _ = single_step(model, sopt, batch, i)
                loss_i.append(float(metrics["loss"]))
            gaps = [abs(s_[i] - l_) / abs(l_) for s_, l_ in zip(loss_s,
                                                                loss_i)]
            worst_gap = max(worst_gap, max(gaps))
            sd_s = {k: v[i] for k, v in stacked.state_dict().items()}
            share_s = {bn: v[i] for bn, v in share.items()}
            state = final_state(ref_model, lr, steps, sd_s, share_s,
                                model.state_dict(), share_i)
            bad = {k: v for k, v in state.items() if v[1] > v[2]}
            check(not bad, f"{what} config {i}: final state outside its "
                  f"bound: {bad}")
            for k, v in state.items():
                if v[1] / v[2] > worst.get(k, (0, 0, 1))[1] / worst.get(
                        k, (0, 0, 1))[2]:
                    worst[k] = v
        check(worst_gap <= 1e-3, f"{what}: per-step losses differ by "
              f"{worst_gap} relative")
        top = sorted(worst, key=lambda k: -worst[k][1] / worst[k][2])[:4]
        print(f"{what}: {c} configs x {steps} steps at lr {lr:g} against "
              f"their single-config steps on stock linears: worst per-step "
              f"loss gap {worst_gap:.2e} (bound 1e-3); final state, largest "
              "against bound: " + "; ".join(
                  f"{k} {worst[k][0]} {worst[k][1]:.3g} (bound "
                  f"{worst[k][2]:g})" for k in top) + f"; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        return dict(configs=c, steps=steps, lr=lr, worst_loss_gap=worst_gap,
                    worst_state={k: worst[k] for k in top},
                    launches=launches, losses_stacked=loss_s)

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                     allow_tf32=False):
        # -- AE, C = 45
        ae = StackedSupervisedAE(mcfg, c_ae).init_configs(0).to(dev)
        singles = [SupervisedAE(mcfg).to(dev) for _ in range(c_ae)]
        alphas_d = torch.tensor(alphas, device=dev)
        lrs_d = torch.full((c_ae,), lr, device=dev)
        cursor = [0]

        def ae_batch():
            lo = cursor[0] * BATCH
            cursor[0] += 1
            idx = slice(lo, lo + BATCH)
            return dict(
                imgs_u8=imgs_tr[idx], labels=labs_tr[idx],
                flip=torch.rand((c_ae, BATCH, 1), device=dev,
                                generator=g) < 0.5,
                offsets=torch.randint(0, 2 * dcfg.crop_padding + 1,
                                      (c_ae, BATCH, 2), device=dev,
                                      generator=g),
                noise=torch.randn((c_ae, BATCH, dcfg.image_size,
                                   dcfg.image_size, dcfg.channels),
                                  device=dev, generator=g))
        out["ae"] = run(
            ae, singles, ae_batch,
            lambda m_, o_, b_: stacked_ae_train_step(
                m_, o_, b_["imgs_u8"], b_["labels"], alphas_d, lrs_d, dcfg,
                flip=b_["flip"], offsets=b_["offsets"], noise=b_["noise"]),
            lambda m_, o_, b_, i: ae_train_step(
                m_, o_, b_["imgs_u8"], b_["labels"], alphas[i], lr, dcfg,
                flip=b_["flip"][i], offsets=b_["offsets"][i],
                noise=b_["noise"][i], linear=L.linear_plain),
            f"stacked AE steps (C={c_ae})",
            counts(fused_gemm_batched=steps * 4,
                   fused_gemm_batched_bwd=steps * 8))
        # -- MLP, C = 11
        mlp = StackedMLP(mcfg, c_mlp).init_configs(1).to(dev)
        msingles = [MLP(mcfg).to(dev) for _ in range(c_mlp)]
        mlrs = torch.full((c_mlp,), lr, device=dev)
        wd = 1e-4

        def mlp_batch():
            return dict(
                x=torch.randn(BATCH, mcfg.latent_dim, device=dev,
                              generator=g),
                labels=torch.randint(0, mcfg.num_classes, (BATCH,),
                                     device=dev, generator=g),
                mask=torch.rand(c_mlp, BATCH, mcfg.mlp_hidden[0], device=dev,
                                generator=g) >= mcfg.mlp_dropout)
        out["mlp"] = run(
            mlp, msingles, mlp_batch,
            lambda m_, o_, b_: stacked_mlp_train_step(
                m_, o_, b_["x"], b_["labels"], mlrs, wd,
                dropout_mask=b_["mask"]),
            lambda m_, o_, b_, i: mlp_train_step(
                m_, o_, b_["x"], b_["labels"], lr, wd,
                dropout_mask=b_["mask"][i], linear=L.linear_plain),
            f"stacked MLP steps (C={c_mlp})",
            counts(fused_gemm_batched=steps * 3,
                   fused_gemm_batched_bwd=steps * 5))

        # -- the stacked AE step's time, in turns with 45 single-config
        # steps on the kernels (fit's deterministic cuDNN)
        batch = ae_batch()
        opt = adam_init(list(ae.parameters()))
        stacked = lambda: stacked_ae_train_step(
            ae, opt, batch["imgs_u8"], batch["labels"], alphas_d, lrs_d,
            dcfg, flip=batch["flip"], offsets=batch["offsets"],
            noise=batch["noise"])
        sopts = [adam_init(list(m.parameters())) for m in singles]
        each = lambda: [ae_train_step(
            singles[i], sopts[i], batch["imgs_u8"], batch["labels"],
            alphas[i], lr, dcfg, flip=batch["flip"][i],
            offsets=batch["offsets"][i], noise=batch["noise"][i])
            for i in range(c_ae)]
        n_time = 5
        turns = {"stacked": [], "single": []}
        for name in ("stacked", "single", "single", "stacked"):
            fn = stacked if name == "stacked" else each
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_time):
                fn()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) / n_time * 1e3)
        stacked_ms, single_ms = (sum(turns[k]) / 2 for k in ("stacked",
                                                             "single"))
        torch.cuda.reset_peak_memory_stats()
        stacked()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        wall, busy, events = profile_device(
            lambda: [stacked() for _ in range(3)])
        # the same step in bf16 (float32 master state), in turns with
        # float32
        noise16 = batch["noise"].to(torch.bfloat16)
        stacked16 = lambda: stacked_ae_train_step(
            ae, opt, batch["imgs_u8"], batch["labels"], alphas_d, lrs_d,
            dcfg, flip=batch["flip"], offsets=batch["offsets"],
            noise=noise16, dtype=torch.bfloat16)
        turns16 = {"float32": [], "bf16": []}
        for name in ("float32", "bf16", "bf16", "float32"):
            fn = stacked if name == "float32" else stacked16
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_time):
                fn()
            torch.cuda.synchronize()
            turns16[name].append((time.perf_counter() - t0) / n_time * 1e3)
    step16 = {k: sum(v) / 2 for k, v in turns16.items()}
    k1_us = {dt: sum(r["device_us"] for r in k21_rows if r["path"] == "ae"
                     and r["kernel"].endswith("_bf16") == (dt == "bf16"))
             for dt in ("float32", "bf16")}
    out.update(stacked_ae_step_ms=stacked_ms, singles_45_ms=single_ms,
               turns_ms=turns, peak_bytes=peak, profile_wall_ms=wall,
               profile_device_ms=busy, profile_top=top_ops(events, 10),
               dtype_turns_ms=turns16, dtype_step_ms=step16,
               batched_k1_us_per_step=k1_us, batched_k1_share={
                   dt: k1_us[dt] / 1e3 / step16[dt] for dt in step16},
               card=card)
    print(f"stacked AE step, C={c_ae}, batch {BATCH}, full width, "
          f"deterministic cuDNN, TF32 off: {stacked_ms:.2f} ms "
          f"({c_ae * BATCH / stacked_ms * 1e3:.0f} config-images/s) against "
          f"{single_ms:.2f} ms for the 45 single-config steps on the kernels"
          f" (in turns: {[round(x, 2) for x in turns['stacked']]} / "
          f"{[round(x, 2) for x in turns['single']]}); 3 stacked steps "
          f"profiled: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; card {card}", flush=True)
    for t, count, key in top_ops(events, 6):
        print(f"  {t:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    print(f"stacked AE step, C={c_ae}, bf16 against float32 in turns: "
          f"{step16['bf16']:.2f} / {step16['float32']:.2f} ms "
          f"({[round(x, 2) for x in turns16['bf16']]} / "
          f"{[round(x, 2) for x in turns16['float32']]}); the batched K1's "
          "device time a step (phase 21's 4 + 8 AE launches): bf16 "
          f"{k1_us['bf16']:.1f} us ({100 * out['batched_k1_share']['bf16']:.2f}"
          f" % of the step), float32 {k1_us['float32']:.1f} us "
          f"({100 * out['batched_k1_share']['float32']:.2f} %); card {card}",
          flush=True)
    return out


def vmap_grid_phase(card: str) -> dict:
    """Phase 23: the pc256 gate's grid with parallel_configs=True (satae's
    vmap engine) in float32 and bf16, each into a run directory of its
    own, with exact launch counts and the outcome against satae's own vmap
    grid of the gate; one epoch of the full 45-config AE sweep at the
    gate's data; the CLI's fit --grid --parallel."""
    import numpy as np
    import torch

    from satae_torch import cli, kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import AETrainConfig, MLPTrainConfig
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.train.extract import extract_chunk
    from satae_torch.train.vmap_sweep import ae_vmap_grid_search

    ref = json.loads(SATAE_GATE_VMAP.read_text())["satae"]
    out = {}
    cfg, gate = gate_config(parallel=True)
    raw = load_dataset(cfg.data)
    splits = make_splits(raw, cfg.data)
    mcfg, bs = cfg.model, cfg.data.batch_size
    n_tr, n_va, n_te = len(splits.train), len(splits.val), len(splits.test)
    steps, val_b, test_b = n_tr // bs, -(-n_va // bs), -(-n_te // bs)
    chunks = sum(-(-n // extract_chunk(n, bs)) for n in (n_tr, n_va, n_te))
    n_ae = len(cfg.ae.alphas) * len(cfg.ae.learning_rates)
    n_lr, e_mlp = len(cfg.mlp.learning_rates), cfg.mlp.epochs
    n_lin_mlp = len(mcfg.mlp_hidden) + 1
    f32 = None
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        cfg, _ = gate_config(dtype, parallel=True)
        what = f"vmap grid {dtype}"
        run = REPO / "chiprun_out" / ("vmap_grid_run" + ("_bf16" if bf16
                                                         else ""))
        shutil.rmtree(run, ignore_errors=True)
        lines = []
        pipe = SatAEPipeline(cfg)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        summary = pipe.fit(raw, grid=True, out_dir=str(run),
                           log=lines.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        e_ae = len(pipe.history["ae"]["train_loss"])
        ae_store = json.loads((run / "validation_losses.json").read_text())
        mlp_store = json.loads((run / "mlp_results.json").read_text())
        want_ae = [json.dumps({"alpha": a, "lr": lr}) for a in cfg.ae.alphas
                   for lr in cfg.ae.learning_rates]
        want_mlp = [json.dumps({"lr": lr}) for lr in cfg.mlp.learning_rates]
        check(list(ae_store) == want_ae and list(mlp_store) == want_mlp,
              f"{what}: store keys {list(ae_store)} {list(mlp_store)}")
        check(e_ae == cfg.ae.max_epochs, f"{what}: {e_ae} AE epochs, "
              f"patience {cfg.ae.patience} cannot stop {cfg.ae.max_epochs} "
              "early")
        # AE: per epoch `steps` stacked steps (4 forward + 8 backward
        # batched launches) and val_b stacked eval batches (4 forward); MLP
        # the same with 3 + 5 and 3; then single-config extraction (chunks
        # x (4 K2 + 1 K1)), each lr's test batches (3 K1 each) and the
        # winner's final test pass (3 K1)
        s = "_bf16" if bf16 else ""
        expected = counts(
            fused_gemm=n_lr * test_b * n_lin_mlp + n_lin_mlp,
            fused_gemm_batched=e_mlp * (steps + val_b) * n_lin_mlp,
            fused_gemm_batched_bwd=e_mlp * steps * (2 * n_lin_mlp - 1))
        expected["fused_gemm_batched" + s] += e_ae * (steps + val_b) * 4
        expected["fused_gemm_batched_bwd" + s] += e_ae * steps * 8
        expected["fused_gemm" + s] += chunks
        expected["conv2d_bn_act" + s] += chunks * len(mcfg.encoder_channels)
        print(f"{what}: {fit_s:.2f} s, stage_seconds "
              f"{summary.stage_seconds}; {n_ae} AE configs x {e_ae} epochs "
              f"and {n_lr} MLP lrs x {e_mlp} epochs of {steps} stacked "
              f"steps and {val_b} stacked val batches, {chunks} extraction "
              f"chunks, {test_b} test batches per lr; launches "
              f"{ {k: v for k, v in launches.items() if v} }, expected "
              f"{ {k: v for k, v in expected.items() if v} }; card {card}",
              flush=True)
        check(launches == expected, f"{what}: launch counts differ from the "
              "configs, epochs, steps, eval batches and extraction chunks")
        hist = pipe.history
        for stage_, h in hist.items():
            vals = [v for series in h.values() for v in series]
            check(all(math.isfinite(v) for v in vals),
                  f"{what} {stage_}: a loss is not finite")
            check(h["train_loss"][-1] < h["train_loss"][0],
                  f"{what} {stage_}: train loss did not fall: "
                  f"{h['train_loss']}")
        master = [k for mod in (pipe.ae, pipe.mlp)
                  for k, v in mod.state_dict().items()
                  if v.is_floating_point() and v.dtype != torch.float32]
        check(not master, f"{what}: master state not float32: {master}")
        preds = pipe.predict(splits.test.images)
        check(float((preds == splits.test.labels).mean())
              == summary.test_acc,
              f"{what}: predict after the fit disagrees with test_acc")
        for ln in lines[-2:]:
            print("  " + ln, flush=True)
        gap = abs(summary.test_acc - ref["test_acc"])
        print(f"{what}: winners AE {summary.ae_hparams} (satae's vmap "
              f"{ref['ae_hparams']}), MLP {summary.mlp_hparams} (satae "
              f"{ref['mlp_hparams']}); AE best val loss {summary.ae_val_loss}"
              f" (satae {ref['ae_best_val_loss']}), MLP best val acc "
              f"{summary.mlp_val_acc} (satae {ref['mlp_best_val_acc']}), "
              f"test accuracy {summary.test_acc} (satae's vmap "
              f"{ref['test_acc']}, gap {gap:.4f}, band {gate['band']})"
              + ("" if f32 is None else
                 f"; gap to the port's float32 "
                 f"{abs(summary.test_acc - f32):.4f}") + "; per-lr test "
              f"accuracy {[r['test_acc'] for r in mlp_store.values()]}",
              flush=True)
        if bf16:
            check(summary.test_acc > 0.10, f"{what}: test accuracy "
                  f"{summary.test_acc} is not above chance")
        else:
            check(summary.ae_hparams == ref["ae_hparams"]
                  and summary.mlp_hparams == ref["mlp_hparams"],
                  f"{what}: winners {summary.ae_hparams} "
                  f"{summary.mlp_hparams}, satae's vmap "
                  f"{ref['ae_hparams']} {ref['mlp_hparams']}")
            check(gap <= gate["band"], f"{what}: test accuracy "
                  f"{summary.test_acc} is {gap:.4f} from satae's vmap "
                  f"{ref['test_acc']}")
            f32 = summary.test_acc
        out[dtype] = dict(fit_s=fit_s, summary=summary.__dict__,
                          launches=launches, expected_launches=expected,
                          ae_results=ae_store, mlp_results=mlp_store,
                          test_acc_gap=gap, log_tail=lines[-2:])
        shutil.rmtree(run)

    # one epoch of the full 45-config sweep at the gate's data
    full = AETrainConfig(max_epochs=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        sweep = ae_vmap_grid_search(splits.train, splits.val, model_cfg=mcfg,
                                    data_cfg=cfg.data, ae_cfg=full,
                                    device=torch.device("cuda"), seed=0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lc = kernels.launch_counts()
    n_full = len(full.alphas) * len(full.learning_rates)
    check(lc == counts(fused_gemm_batched=(steps + val_b) * 4,
                       fused_gemm_batched_bwd=steps * 8),
          f"45-config epoch launches {lc}")
    check(len(sweep.results) == n_full and all(
        math.isfinite(r["best_val_loss"]) for r in sweep.results.values()),
        "45-config epoch: results")
    out["full_epoch"] = dict(configs=n_full, seconds=epoch_s,
                             ms_per_stacked_step=epoch_s * 1e3 / (
                                 steps + val_b),
                             peak_bytes=peak, launches=lc)
    print(f"one epoch of the full {n_full}-config AE sweep (per_class "
          f"{cfg.data.per_class}, full width, batch {bs}): {epoch_s:.2f} s "
          f"incl. set-up and the val pass, {epoch_s * 1e3 / steps:.1f} ms "
          f"per stacked train step (wall / {steps}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; card {card}", flush=True)

    # the CLI, 1 + 1 epochs of the default grids (45 AE configs, 11 lrs);
    # fit --grid draws the grid's heatmap after writing every artifact, and
    # raises ImportError there without matplotlib (satae's CLI too)
    import contextlib
    import importlib.util
    import io
    crun, cache = REPO / "chiprun_out" / "vmap_cli_run", \
        REPO / "chiprun_out" / "vmap_cli_cache"
    shutil.rmtree(crun, ignore_errors=True)
    plots = importlib.util.find_spec("matplotlib") is not None
    stdout = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        try:
            cli.main(["fit", "--grid", "--parallel", "--ae-epochs", "1",
                      "--mlp-epochs", "1", "--per-class", "256",
                      "--synthetic-difficulty", "hard", "--seed", "0",
                      "--out", str(crun), "--cache-dir", str(cache)])
        except ImportError:
            check(not plots, "cli fit --grid --parallel: ImportError with "
                  "matplotlib installed")
    cli_s = time.perf_counter() - t0
    cli_launches = kernels.launch_counts()
    text = stdout.getvalue()
    summary = json.loads(text[text.index("{\n"):])
    names = {p.name for p in crun.iterdir()}
    want = {"ae_global_best.json", "ae_global_best.msgpack", "classes.json",
            "fit_summary.json", "metrics.jsonl", "mlp_global_best.json",
            "mlp_global_best.msgpack", "mlp_provenance.json",
            "mlp_results.json", "validation_losses.json"}
    check(names == (want | {"gridsearch_heatmap.png", "ae_best_curves.png",
                            "mlp_best_curves.png"} if plots else want),
          f"cli fit --grid --parallel wrote {names}")
    check(len(json.loads((crun / "validation_losses.json").read_text()))
          == 45 and len(json.loads((crun / "mlp_results.json").read_text()))
          == 11, "cli fit --grid --parallel: store sizes")
    n_cli_lr = len(MLPTrainConfig().learning_rates)
    want_cli = counts(
        fused_gemm=chunks + n_cli_lr * test_b * n_lin_mlp + n_lin_mlp,
        conv2d_bn_act=chunks * len(mcfg.encoder_channels),
        fused_gemm_batched=(steps + val_b) * (4 + n_lin_mlp),
        fused_gemm_batched_bwd=steps * (8 + 2 * n_lin_mlp - 1))
    check(cli_launches == want_cli, f"cli fit --grid --parallel launches "
          f"{cli_launches}, expected {want_cli}")
    out["cli"] = dict(seconds=cli_s, summary=summary, launches=cli_launches,
                      files=sorted(names))
    print(f"cli fit --grid --parallel (45 AE configs x 1 epoch, 11 lrs x 1 "
          f"epoch, per_class 256): {cli_s:.2f} s, test accuracy "
          f"{summary['test_acc']}, winners {summary['ae_hparams']} "
          f"{summary['mlp_hparams']}; launches "
          f"{ {k: v for k, v in cli_launches.items() if v} }; figures "
          f"{'drawn' if plots else 'not drawn (no matplotlib)'}",
          flush=True)
    shutil.rmtree(crun)
    shutil.rmtree(cache, ignore_errors=True)
    out["card"] = card
    return out


def steps_engine_phase(card: str) -> dict:
    """Phase 24: satae's per-batch engine on the gate's data:
    ae_grid_search(engine="steps") for 2 configs x 2 epochs, then
    mlp_grid_search(engine="steps") for 2 lrs x 2 epochs on the winner's
    latents, with exact K1 launches (the remainder batch counted, eval
    batches unpadded), satae's store keys, finite and falling losses."""
    import torch

    from satae_torch import kernels
    from satae_torch.config import AETrainConfig, MLPTrainConfig
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn.layers import float32_convs
    from satae_torch.train.extract import extract_features
    from satae_torch.train.gridsearch import ae_grid_search, mlp_grid_search

    cfg, _ = gate_config()
    splits = make_splits(load_dataset(cfg.data), cfg.data)
    mcfg, bs = cfg.model, cfg.data.batch_size
    dev = torch.device("cuda")
    n_tr, n_va = len(splits.train), len(splits.val)
    steps, val_b = -(-n_tr // bs), -(-n_va // bs)
    run = REPO / "chiprun_out" / "steps_run"
    shutil.rmtree(run, ignore_errors=True)
    ae_cfg = AETrainConfig(alphas=(20.0, 35.0), learning_rates=(1e-3,),
                           max_epochs=2, patience=2)
    mlp_cfg = MLPTrainConfig(learning_rates=(1e-3, 1e-2), epochs=2)
    out = {}
    with float32_convs(deterministic=True):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sweep = ae_grid_search(splits.train, splits.val, model_cfg=mcfg,
                               data_cfg=cfg.data, ae_cfg=ae_cfg, device=dev,
                               seed=0, out_dir=str(run), engine="steps")
        torch.cuda.synchronize()
        ae_s = time.perf_counter() - t0
        ae_launches = kernels.launch_counts()
        ae = SupervisedAE(mcfg).to(dev)
        ae.load_state_dict(sweep.best.state_dict())
        ae.eval()
        Xtr, ytr = extract_features(ae.enc, splits.train, bs)
        Xva, yva = extract_features(ae.enc, splits.val, bs)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        msweep = mlp_grid_search(Xtr, ytr, Xva, yva, model_cfg=mcfg,
                                 mlp_cfg=mlp_cfg, device=dev, batch_size=bs,
                                 seed=0, out_dir=str(run), engine="steps")
        torch.cuda.synchronize()
        mlp_s = time.perf_counter() - t0
        mlp_launches = kernels.launch_counts()
    n_cfg, n_lr = 2, 2
    want_ae = counts(fused_gemm=n_cfg * 2 * (steps + val_b) * 4,
                     fused_gemm_bwd=n_cfg * 2 * steps * 8)
    want_mlp = counts(fused_gemm=n_lr * 2 * (steps + val_b) * 3,
                      fused_gemm_bwd=n_lr * 2 * steps * 5)
    print(f"steps engine: {n_tr} train images are {n_tr // bs} batches of "
          f"{bs} and one of {n_tr % bs}, {val_b} unpadded val batches; AE "
          f"{n_cfg} configs x 2 epochs {ae_s:.2f} s, launches "
          f"{ {k: v for k, v in ae_launches.items() if v} } (expected "
          f"{ {k: v for k, v in want_ae.items() if v} }); MLP {n_lr} lrs x "
          f"2 epochs {mlp_s:.2f} s, launches "
          f"{ {k: v for k, v in mlp_launches.items() if v} } (expected "
          f"{ {k: v for k, v in want_mlp.items() if v} }); card {card}",
          flush=True)
    check(ae_launches == want_ae, "steps engine AE launches")
    check(mlp_launches == want_mlp, "steps engine MLP launches")
    ae_store = json.loads((run / "validation_losses.json").read_text())
    mlp_store = json.loads((run / "mlp_results.json").read_text())
    check(list(ae_store) == [json.dumps({"alpha": a, "lr": 1e-3})
                             for a in ae_cfg.alphas]
          and all(set(r) == {"alpha", "lr", "best_val_loss", "best_val_acc",
                             "best_epoch", "epochs_run"}
                  for r in ae_store.values()), f"AE store {ae_store}")
    check(list(mlp_store) == [json.dumps({"lr": lr})
                              for lr in mlp_cfg.learning_rates]
          and all(set(r) == {"lr", "best_val_acc", "best_val_loss",
                             "best_epoch"} for r in mlp_store.values()),
          f"MLP store {mlp_store}")
    for what, h in (("AE", sweep.best.history), ("MLP", msweep.best.history)):
        check(all(math.isfinite(v) for vs in h.values() for v in vs),
              f"steps engine {what}: a loss is not finite")
        check(h["train_loss"][1] < h["train_loss"][0],
              f"steps engine {what}: train loss did not fall "
              f"{h['train_loss']}")
    print(f"steps engine: AE winner {sweep.best_hparams} val loss "
          f"{sweep.best.best_val_loss:.4f}, train loss "
          f"{sweep.best.history['train_loss']}; MLP winner "
          f"{msweep.best_hparams} val acc {msweep.best.best_val_acc:.4f}",
          flush=True)
    out.update(ae_s=ae_s, mlp_s=mlp_s, ae_launches=ae_launches,
               mlp_launches=mlp_launches, ae_results=ae_store,
               mlp_results=mlp_store, card=card)
    shutil.rmtree(run)
    return out


def vmap_main() -> int:
    """``--vmap``: build, then phases 21-24 alone, details in
    chiprun_out/vmap.json."""
    import torch

    from satae_torch.config import DataConfig
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.kernels import _build

    check(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = _build.ptxas_report()
    spilled = [r["kernel"] for r in ptxas
               if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"ptxas spills registers in {spilled}")
    check(len(ptxas) == N_INSTANTIATIONS, f"{len(ptxas)} instantiations")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = DataConfig(per_class=2000, synthetic_difficulty="hard")
    splits = make_splits(load_dataset(data), data)
    res, secs = {}, {}
    for n, fn in ((21, lambda: batched_kernels_phase(card)),
                  (22, lambda: stacked_steps_phase(card, splits,
                                                   res[21]["rows"])),
                  (23, lambda: vmap_grid_phase(card)),
                  (24, lambda: steps_engine_phase(card))):
        t0 = time.perf_counter()
        res[n] = fn()
        secs[n] = time.perf_counter() - t0
    print("seconds of phases 21-24: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "vmap.json").write_text(json.dumps(dict(
        card=card, phases=res, seconds=secs), indent=1, default=str))
    return 0


# two ranks of phases 26 and 27 on the one card: Gloo over a file store
# (NCCL puts no two ranks on one device); argv: task, rank, directory
PARALLEL_CHILD = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from satae_torch import kernels
task, rank, tmp = sys.argv[1], int(sys.argv[2]), Path(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=2)
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
from chip_smoke import dp_steps, sharded_grid_rank
from satae_torch.parallel import make_mesh
mesh = make_mesh(2, device=dev)
kernels.reset_launch_counts()
if task == "steps":
    out = dp_steps(np.load(tmp / "data.npz"), dev, mesh)
else:
    out = sharded_grid_rank(dev, mesh, tmp / f"rank{rank}")
torch.cuda.synchronize()
out["launches"] = kernels.launch_counts()
torch.save(out, tmp / f"result{rank}.pt")
dist.barrier()
dist.destroy_process_group()
"""

# phase 28's CLI under torch.distributed.run: satae_torch.cli's main, then
# the launch counts of its process
TORCHRUN_CHILD = r"""
import importlib.util, json, sys
from satae_torch import cli, kernels
kernels.reset_launch_counts()
try:
    cli.main(sys.argv[1:])
except ImportError:  # fit --grid draws its heatmap last: no matplotlib here
    if importlib.util.find_spec("matplotlib") is not None:
        raise
print("LAUNCHES " + json.dumps(kernels.launch_counts()), flush=True)
"""


def run_ranks(task: str, tmp: Path, timeout: int = 900) -> list:
    """PARALLEL_CHILD's ``task`` on two ranks, each a process of its own on
    the first card; their results. Both processes are stopped on return."""
    import torch

    logs = [tmp / f"log{r}.txt" for r in range(2)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", PARALLEL_CHILD, task, str(r),
                     str(tmp)], stdout=f, stderr=subprocess.STDOUT,
                    cwd=str(REPO)))
        t_end = time.perf_counter() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} of {task} failed:\n"
              f"{log.read_text()[-3000:]}")
    return [torch.load(tmp / f"result{r}.pt", weights_only=False)
            for r in range(2)]


def dp_steps(data, dev, mesh=None) -> dict:
    """Phase 26's run: 10 AE steps at lr 1e-5 from init_ seeded 0 on the
    global batches of ``data`` (64 images each; this rank's rows with
    ``mesh``), the draws from a generator on ``dev`` seeded 0 (the global
    batch's on every rank), deterministic cuDNN; and the weighted eval of
    the init on ``data``'s odd-length val split. Per-step losses, the state
    after the first step and the last, each BatchNorm's share of the biases
    that feed it, the eval's sums."""
    import torch

    from satae_torch.config import DataConfig, ModelConfig
    from satae_torch.data.pipeline import ArrayDataset
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn.init import init_
    from satae_torch.nn.layers import float32_convs
    from satae_torch.parallel import replicate
    from satae_torch.train import hbm
    from satae_torch.train.fast_loop import upload_eval_batches
    from satae_torch.train.optim import adam_init
    from satae_torch.train.steps import ae_train_step

    dcfg = DataConfig()
    model = SupervisedAE(ModelConfig(), dcfg.channels, dcfg.image_size)
    init_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    if mesh is not None:
        replicate(mesh, model)
    val = upload_eval_batches(ArrayDataset(data["val_x"], data["val_y"]),
                              BATCH, dev)
    with float32_convs(deterministic=True):
        out = {"eval": {k: float(v) for k, v in hbm.ae_eval_sums(
            model, *val, 35.0, mesh=mesh).items()}}
    opt = adam_init(list(model.parameters()))
    gen = torch.Generator(device=dev).manual_seed(0)
    pairs = pre_bn_biases(model)
    share = {bn: 0.0 for _, bn in pairs}
    x = torch.from_numpy(data["train_x"]).to(dev)
    y = torch.from_numpy(data["train_y"]).to(dev).long()
    losses = []
    with float32_convs(deterministic=True):
        for s in range(PARITY_STEPS):
            sd = model.state_dict()
            for b_name, bn in pairs:
                share[bn] = 0.9 * share[bn] + 0.1 * sd[b_name]
            xb, yb = x[s * BATCH:(s + 1) * BATCH], y[s * BATCH:(s + 1) * BATCH]
            if mesh is not None:
                xb, yb = mesh.shard(xb), mesh.shard(yb)
            m, _ = ae_train_step(model, opt, xb, yb, 35.0, 1e-5, dcfg,
                                 generator=gen, mesh=mesh)
            losses.append(float(m["loss"]))
            if s == 0:
                out["after_first"] = {k: v.clone().cpu() for k, v in
                                      model.state_dict().items()}
    out.update(losses=losses, share={k: v.cpu() for k, v in share.items()},
               final={k: v.cpu() for k, v in model.state_dict().items()})
    return out


def dp_ranks_phase(card: str, splits, dev=None) -> dict:
    """Phase 26: two ranks on the one card over Gloo (PARALLEL_CHILD), 10
    data-parallel AE steps on 32 rows each of the global batches of 64,
    against the same 10 steps of one rank on the whole batches in this
    process (the same init and global draws): held to phase 9's bounds,
    BatchNorm running stats after the first step within 1e-5 (global-batch
    moments), the two ranks' states bitwise equal; the weighted eval of a
    val split of odd length: counts equal, sums within 1e-5 relative."""
    import tempfile

    import numpy as np
    import torch

    from satae_torch import kernels
    from satae_torch.config import ModelConfig
    from satae_torch.models.supervised_ae import SupervisedAE

    n_val = 1001
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.savez(tmp / "data.npz",
                 train_x=splits.train.images[:PARITY_STEPS * BATCH],
                 train_y=splits.train.labels[:PARITY_STEPS * BATCH],
                 val_x=splits.val.images[:n_val],
                 val_y=splits.val.labels[:n_val])
        t0 = time.perf_counter()
        ranks = run_ranks("steps", tmp)
        ranks_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        ref = dp_steps(np.load(tmp / "data.npz"), dev or torch.device("cuda"))
        torch.cuda.synchronize()
        ref_launches = kernels.launch_counts()
    r0, r1 = ranks
    differ = [k for k, v in r0["final"].items()
              if not torch.equal(v, r1["final"][k])]
    gaps = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"])]
    model = SupervisedAE(ModelConfig(), 3, 64)
    state = final_state(model, 1e-5, PARITY_STEPS, r0["final"], r0["share"],
                        ref["final"], ref["share"])
    bn_err = max(float((r0["after_first"][k] - v).abs().max())
                 for k, v in ref["after_first"].items()
                 if k.endswith(("running_mean", "running_var")))
    ev_gap = {k: abs(r0["eval"][k] - v) / max(abs(v), 1e-30)
              for k, v in ref["eval"].items()}
    n_val_b = -(-n_val // BATCH)
    want_rank = counts(fused_gemm=PARITY_STEPS * 4 + n_val_b * 4,
                       fused_gemm_bwd=PARITY_STEPS * 8)
    print(f"two ranks on one card over Gloo: 10 DP AE steps at lr 1e-5 "
          f"(32 rows a rank of 64) in {ranks_s:.2f} s with process start; "
          f"per-step loss gaps to one rank "
          + " ".join(f"{g:.1e}" for g in gaps)
          + f"; BatchNorm running stats after step 1 max |diff| "
          f"{bn_err:.3g}; final state, largest against bound: "
          + ", ".join(f"{k} {v[0]} {v[1]:.3g} (bound {v[2]:g})" for k, v in
                      sorted(state.items(), key=lambda kv: -kv[1][1]
                             / kv[1][2])[:3])
          + f"; weighted eval of {n_val} val images: sums {r0['eval']} vs "
          f"one rank {ref['eval']}; launches per rank {r0['launches']}; "
          f"card {card}", flush=True)
    check(not differ, f"the two ranks' states differ in {differ}")
    check(max(gaps) <= 1e-3, f"DP losses differ by {max(gaps)} relative")
    bad = {k: v for k, v in state.items() if v[1] > v[2]}
    check(not bad, f"DP final state outside its bound: {bad}")
    check(bn_err <= 1e-5, f"BatchNorm running stats after one DP step differ "
          f"by {bn_err}: the moments were not the global batch's")
    check(r0["eval"]["n"] == ref["eval"]["n"] == n_val
          and r0["eval"]["acc"] == ref["eval"]["acc"],
          f"DP eval counts {r0['eval']} vs {ref['eval']}")
    check(max(ev_gap.values()) <= 1e-5, f"DP eval sums {ev_gap}")
    check(r0["launches"] == r1["launches"] == want_rank,
          f"launches per rank {r0['launches']} {r1['launches']}, expected "
          f"{want_rank}")
    check(ref_launches == want_rank,
          f"one-rank launches {ref_launches}")
    return dict(seconds_two_ranks=ranks_s, loss_gaps=gaps,
                losses=r0["losses"], losses_one_rank=ref["losses"],
                bn_after_first_max_abs=bn_err, final_state=state,
                eval=r0["eval"], eval_one_rank=ref["eval"], eval_gaps=ev_gap,
                launches_per_rank=r0["launches"], card=card)


def dp_fit_phase(card: str, fit_cfg, raw, ref: dict) -> dict:
    """Phase 25: phase 10's fit with ``runtime.n_devices = 1``: a single-rank
    NCCL group made in this process, the data-parallel trainer, extraction
    and serving paths with their collectives over it. Its launches and its
    summary and curves must be phase 10's (``ref``), bit for bit."""
    import torch
    import torch.distributed as dist

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline

    cfg = dataclasses.replace(fit_cfg, runtime=dataclasses.replace(
        fit_cfg.runtime, n_devices=1))
    pipe = SatAEPipeline(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = pipe.fit(raw, grid=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    backend = dist.get_backend()
    fields = ("ae_val_loss", "ae_hparams", "mlp_val_acc", "mlp_hparams",
              "test_acc")
    differ = [f for f in fields
              if getattr(summary, f) != getattr(ref["summary"], f)]
    print(f"DP fit at world size 1 ({backend}, {dist.get_world_size()} rank):"
          f" {fit_s:.2f} s (phase 10: {ref['fit_s']:.2f} s), stage_seconds "
          f"{summary.stage_seconds}; launches {launches} (phase 10: "
          f"{ref['launches']}); AE best val loss {summary.ae_val_loss}, test "
          f"accuracy {summary.test_acc}; summary fields that differ from "
          f"phase 10: {differ}; card {card}", flush=True)
    check(backend == "nccl" and dist.get_world_size() == 1,
          f"the DP fit's group: {backend}, {dist.get_world_size()} ranks")
    check(launches == ref["launches"], "DP fit launches differ from phase 10")
    check(not differ, f"the DP fit's summary differs from phase 10 in "
          f"{differ}")
    check(pipe.history == ref["hist"], "the DP fit's curves differ from "
          "phase 10's")
    return dict(fit_s=fit_s, launches=launches, summary=summary.__dict__,
                backend=backend, card=card)


def sharded_grid_rank(dev, mesh, out_dir: Path) -> dict:
    """Phase 27's run on one of two ranks: the gate's AE and MLP grids
    through ae_sharded_grid_search and mlp_sharded_grid_search (fit's
    extraction all-gathers CUDA tensors, which Gloo does not), into this
    rank's own run directory, the latents extracted on each rank from the
    AE winner as fit extracts them, with fit's deterministic cuDNN."""
    import torch

    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn.layers import float32_convs
    from satae_torch.train.extract import extract_features
    from satae_torch.train.shard_sweep import (ae_sharded_grid_search,
                                               mlp_sharded_grid_search)

    cfg, _ = gate_config()
    splits = make_splits(load_dataset(cfg.data), cfg.data)
    bs, seed = cfg.data.batch_size, cfg.runtime.seed
    t0 = time.perf_counter()
    with float32_convs(deterministic=True):
        ae = ae_sharded_grid_search(
            splits.train, splits.val, model_cfg=cfg.model, data_cfg=cfg.data,
            ae_cfg=cfg.ae, mesh=mesh, device=dev, seed=seed,
            out_dir=str(out_dir))
        model = SupervisedAE(cfg.model, cfg.data.channels,
                             cfg.data.image_size).to(dev)
        model.load_state_dict(ae.best.state_dict())
        model.eval()
        (xtr, ytr), (xva, yva), (xte, yte) = (
            extract_features(model.enc, ds, bs)
            for ds in (splits.train, splits.val, splits.test))
        mlp = mlp_sharded_grid_search(
            xtr, ytr, xva, yva, model_cfg=cfg.model, mlp_cfg=cfg.mlp,
            mesh=mesh, device=dev, batch_size=bs, seed=seed,
            out_dir=str(out_dir), test_x=xte, test_y=yte)
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, ae_hparams=ae.best_hparams,
                mlp_hparams=mlp.best_hparams,
                files={name: (out_dir / name).read_bytes()
                       for name in SHARDED_FILES})


# what a sharded grid writes into its run directory: the stores and the
# winners' checkpoints with their selection meta
SHARDED_FILES = ("validation_losses.json", "mlp_results.json",
                 "ae_global_best.msgpack", "ae_global_best.json",
                 "mlp_global_best.msgpack", "mlp_global_best.json")


def sharded_grid_phase(card: str, ref: dict) -> dict:
    """Phase 27: the pc256 gate's grid through the config-sharded sweeps,
    at world size 1 over NCCL (fit(grid=True) with ``n_devices = 1``) and on
    two Gloo ranks on the one card (PARALLEL_CHILD): every config trains
    alone on its rank with its sequential seed and deterministic cuDNN, so
    each config's result is phase 12's (``ref``) bit for bit, the winners
    are satae's and phase 12's, and the stores and checkpoints are the same
    bytes from both ranks and from the one-rank run."""
    import tempfile

    import torch
    import torch.distributed as dist

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.data.ingest import load_dataset

    cfg, gate = gate_config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, n_devices=1))
    raw = load_dataset(cfg.data)
    run = REPO / "chiprun_out" / "sharded_grid_run"
    shutil.rmtree(run, ignore_errors=True)
    pipe = SatAEPipeline(cfg)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = pipe.fit(raw, grid=True, out_dir=str(run))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    one_files = {name: (run / name).read_bytes() for name in SHARDED_FILES}
    ae_store = json.loads(one_files["validation_losses.json"])
    mlp_store = json.loads(one_files["mlp_results.json"])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks("grid", Path(tmp))
        two_s = time.perf_counter() - t0
    rec = gate["satae"]
    print(f"sharded grid of the pc256 gate: world size 1 ("
          f"{dist.get_backend()}) {one_s:.2f} s (phase 12, sequential: "
          f"{ref['fit_s']:.2f} s), two Gloo ranks on the card "
          f"{two_s:.2f} s with process start (each rank's sweeps "
          f"{[round(r['seconds'], 2) for r in ranks]} s); winners AE "
          f"{summary.ae_hparams}, MLP {summary.mlp_hparams} (satae "
          f"{rec['ae_hparams']} {rec['mlp_hparams']}; two ranks "
          f"{ranks[0]['ae_hparams']} {ranks[0]['mlp_hparams']}); test "
          f"accuracy {summary.test_acc} (phase 12 "
          f"{ref['summary']['test_acc']}); launches {launches}; per rank of "
          f"two {[r['launches'] for r in ranks]}; card {card}", flush=True)
    check(launches == ref["launches"], f"sharded grid launches {launches}, "
          f"phase 12's {ref['launches']}")
    check(ae_store == ref["ae_results"] and mlp_store == ref["mlp_results"],
          "the sharded grid's per-config results are not phase 12's")
    for f in ("ae_hparams", "ae_val_loss", "mlp_hparams", "mlp_val_acc",
              "test_acc"):
        check(getattr(summary, f) == ref["summary"][f],
              f"sharded grid {f} {getattr(summary, f)}, phase 12 "
              f"{ref['summary'][f]}")
    check(summary.ae_hparams == rec["ae_hparams"]
          and summary.mlp_hparams == rec["mlp_hparams"],
          "sharded grid winners are not satae's")
    for r, res in enumerate(ranks):
        check(res["ae_hparams"] == summary.ae_hparams
              and res["mlp_hparams"] == summary.mlp_hparams,
              f"rank {r} of two: winners {res['ae_hparams']} "
              f"{res['mlp_hparams']}")
        differ = [n for n in SHARDED_FILES
                  if res["files"][n] != one_files[n]]
        check(not differ, f"rank {r} of two wrote other bytes than the "
              f"one-rank run: {differ}")
        check(res["launches"]["fused_gemm_bwd"] > 0,
              f"rank {r} of two trained nothing: {res['launches']}")
    shutil.rmtree(run)
    return dict(one_rank_s=one_s, two_ranks_s=two_s,
                rank_sweep_s=[r["seconds"] for r in ranks],
                launches=launches,
                launches_per_rank_of_two=[r["launches"] for r in ranks],
                summary=summary.__dict__, card=card)


def sharded_serve_phase(card: str, data_cfg, test) -> dict:
    """Phase 28: benchmarks/full_run_hard_f32 served with ``n_devices = 1``
    (each chunk sharded over the one rank's group and all-gathered) beside
    the plain pipeline, over the test split: the same launches, predictions
    equal on >= 99.9 % and accuracy within phase 6's 0.002 of the recorded
    one, latents within 1e-3, decoded images within phase 17's bounds; then
    ``satae_torch.cli fit --grid --multihost --n-devices 1`` under
    ``torch.distributed.run`` (TORCHRUN_CHILD), which must write satae's
    artifacts with K1 and K2 launches."""
    import tempfile

    import numpy as np
    import torch

    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import PipelineConfig, RuntimeConfig

    cfg = PipelineConfig(data=data_cfg)
    out = {}
    for name, rt in (("plain", RuntimeConfig()),
                     ("sharded", RuntimeConfig(n_devices=1))):
        pipe = SatAEPipeline(dataclasses.replace(cfg, runtime=rt)).load(
            str(CKPT))
        res = {}
        for what, fn in (("predict", lambda: pipe.predict(test.images)),
                         ("encode", lambda: pipe.encode(test.images)),
                         ("decode", lambda: pipe.decode(res["encode"][0])),
                         ("reconstruct",
                          lambda: pipe.reconstruct(test.images))):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize()
            res[what] = (y, time.perf_counter() - t0, kernels.launch_counts())
        out[name] = res
    p, s = out["plain"], out["sharded"]
    acc = float((s["predict"][0] == test.labels).mean())
    ref_acc = json.loads((CKPT / "fit_summary.json").read_text())["test_acc"]
    agree = float((s["predict"][0] == p["predict"][0]).mean())
    dz = float(np.abs(s["encode"][0] - p["encode"][0]).max())
    # one rank runs the plain pipeline's arithmetic on the same chunks: the
    # images must be its own bit for bit
    dx = {w: float(np.abs(s[w][0] - p[w][0]).max())
          for w in ("decode", "reconstruct")}
    ops = ("predict", "encode", "decode", "reconstruct")
    print(f"sharded serving of {CKPT.name} at world size 1: accuracy "
          f"{acc:.6f} (recorded {ref_acc:.6f}), predictions equal to the "
          f"plain pipeline's on {agree:.6f}, latents max |diff| {dz:.3g}, "
          f"images max |diff| {dx}; seconds "
          + ", ".join(f"{w} {s[w][1]:.3f} (plain {p[w][1]:.3f})"
                      for w in ops)
          + f"; launches {[s[w][2] for w in ops]}; card {card}", flush=True)
    for w in ops:
        check(s[w][2] == p[w][2], f"sharded {w} launches {s[w][2]}, plain "
              f"{p[w][2]}")
    check(abs(acc - ref_acc) <= 0.002 and agree >= 0.999,
          f"sharded predict: accuracy {acc}, agreement {agree}")
    check(dz <= 1e-3, f"sharded latents differ by {dz}")
    check(all(v == 0.0 for v in dx.values()),
          f"sharded decode / reconstruct differ from the plain pipeline's "
          f"by {dx}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        child = tmp / "torchrun_cli.py"
        child.write_text(TORCHRUN_CHILD)
        run = tmp / "run"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", str(child), "fit", "--grid",
             "--multihost", "--n-devices", "1", "--device", "cuda",
             "--per-class", "12", "--ae-epochs", "1", "--mlp-epochs", "1",
             "--synthetic-difficulty", "hard", "--out", str(run),
             "--cache-dir", str(tmp / "cache")],
            capture_output=True, text=True, timeout=600, cwd=str(REPO),
            env={**os.environ, "PYTHONPATH": str(REPO)})
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"torchrun cli fit failed:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("LAUNCHES ")]
        check(len(line) == 1, f"torchrun cli fit: no launch counts\n"
              f"{proc.stdout[-2000:]}")
        cli_launches = json.loads(line[0][len("LAUNCHES "):])
        names = sorted(f.name for f in run.iterdir())
        text = proc.stdout
        summary = json.loads(text[text.index("{\n"):text.index("\n}") + 2])
        stores = [len(json.loads((run / n).read_text())) for n in
                  ("validation_losses.json", "mlp_results.json")]
    want = {"ae_global_best.json", "ae_global_best.msgpack", "classes.json",
            "fit_summary.json", "metrics.jsonl", "mlp_global_best.json",
            "mlp_global_best.msgpack", "mlp_provenance.json",
            "mlp_results.json", "validation_losses.json"}
    print(f"torchrun --standalone --nproc-per-node 1 satae_torch.cli fit "
          f"--grid --multihost --n-devices 1 (per_class 12, 1 + 1 epochs): "
          f"{cli_s:.2f} s with process start; wrote {names}; stores "
          f"{stores}; test accuracy {summary['test_acc']}, winners "
          f"{summary['ae_hparams']} {summary['mlp_hparams']}; launches "
          f"{ {k: v for k, v in cli_launches.items() if v} }", flush=True)
    check(want <= set(names), f"torchrun cli fit wrote {names}")
    check(stores == [45, 11], f"torchrun cli fit stores {stores}")
    check(cli_launches["fused_gemm"] > 0 and cli_launches["conv2d_bn_act"] > 0
          and cli_launches["fused_gemm_bwd"] > 0,
          f"torchrun cli fit launches {cli_launches}")
    return dict(accuracy=acc, agree=agree, max_dz=dz, images_max_abs=dx,
                seconds={w: (s[w][1], p[w][1]) for w in ops},
                launches={w: s[w][2] for w in ops},
                cli=dict(seconds=cli_s, files=names, stores=stores,
                         summary=summary, launches=cli_launches), card=card)


def parallel_phases(card: str, fit_cfg, raw, splits, data_cfg, fit_ref,
                    grid_ref) -> dict:
    """Phases 25-28 in order, each one's seconds printed; the single-rank
    group phase 25 makes is destroyed at the end."""
    import torch.distributed as dist

    res, secs = {}, {}
    for n, fn in ((25, lambda: dp_fit_phase(card, fit_cfg, raw, fit_ref)),
                  (26, lambda: dp_ranks_phase(card, splits)),
                  (27, lambda: sharded_grid_phase(card, grid_ref)),
                  (28, lambda: sharded_serve_phase(card, data_cfg,
                                                   splits.test))):
        t0 = time.perf_counter()
        res[n] = fn()
        secs[n] = time.perf_counter() - t0
    print("seconds of phases 25-28: " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    res["seconds"] = secs
    return res


def example_phase(card: str) -> dict:
    """Phase 29: examples/reproduce_reference_torch.py --quick
    --synthetic-difficulty hard, its main() in this process on the card,
    with the launch counts zeroed before and read after: satae's final.json
    keys, finite losses, K1, K1's backward and K2 launched, test accuracy
    within EXAMPLE_BAND of satae's run of its own example; the winners,
    the calibration median and each stage's seconds printed."""
    import contextlib
    import importlib.util
    import io

    import numpy as np

    from satae_torch import kernels
    from satae_torch.io.checkpoint import load_grid_results

    ref = json.loads(SATAE_EXAMPLE_REF.read_text())["satae"]
    check([k for k in ref if k in EXAMPLE_KEYS] == EXAMPLE_KEYS,
          f"{SATAE_EXAMPLE_REF.name} lacks final.json's keys: {list(ref)}")
    spec = importlib.util.spec_from_file_location(
        "reproduce_reference_torch",
        REPO / "examples" / "reproduce_reference_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    run = REPO / "chiprun_out" / "example_run"
    shutil.rmtree(run, ignore_errors=True)
    stdout = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        example.main(["--quick", "--synthetic-difficulty", "hard", "--out",
                      str(run)])
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    (REPO / "chiprun_out" / "example_stdout.txt").write_text(
        stdout.getvalue())
    final = json.loads((run / "final.json").read_text())
    skipped = sorted(f for f in EXAMPLE_FIGURES if f"matplotlib is not "
                     f"installed: {f} not written" in stdout.getvalue())
    written = sorted(p.name for p in run.glob("*.png"))
    losses = [r["best_val_loss"] for r in load_grid_results(
        run / "validation_losses.json").values()] + [
        json.loads((run / "fit_summary.json").read_text())["ae_val_loss"]]
    gap = abs(final["test_accuracy"] - ref["test_accuracy"])
    print(f"example --quick --synthetic-difficulty hard: {wall:.2f} s; test "
          f"accuracy {final['test_accuracy']!r} (satae's run on a CPU "
          f"{ref['test_accuracy']!r}, gap {gap:.4f}, band {EXAMPLE_BAND}); "
          f"winners AE {final['ae']} MLP {final['mlp']} (satae AE "
          f"{ref['ae']} MLP {ref['mlp']}); calibration median "
          f"{final['calibration_median']:.4f} (satae "
          f"{ref['calibration_median']:.4f}); stage seconds "
          f"{final['timings_s']} (satae on a CPU {ref['timings_s']}); "
          f"launches {launches}; figures written {written}, skipped "
          f"{skipped}; card {card}", flush=True)
    check(list(final) == EXAMPLE_KEYS, f"final.json keys {list(final)}")
    check(list(final["timings_s"]) == list(ref["timings_s"]),
          f"stages {list(final['timings_s'])}")
    check(all(launches[k] > 0 for k in ("fused_gemm", "fused_gemm_bwd",
                                         "conv2d_bn_act")),
          f"example launches {launches}")
    check(bool(np.isfinite(losses).all()), f"example losses {losses}")
    check(set(EXAMPLE_FIGURES) <= set(written) | set(skipped)
          and not set(written) & set(skipped),
          f"figures: written {written}, skipped {skipped}")
    check(gap <= EXAMPLE_BAND, f"example test accuracy "
          f"{final['test_accuracy']} is {gap} from satae's "
          f"{ref['test_accuracy']}")
    shutil.rmtree(run)
    return dict(seconds=wall, final=final, satae=ref, gap=gap,
                launches=launches, figures_written=written,
                figures_skipped=skipped, card=card)


def example_main() -> int:
    """``--example``: build, then phase 29 alone, details in
    chiprun_out/example.json."""
    import torch

    from satae_torch.kernels import _build

    check(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    res = example_phase(card)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "example.json").write_text(json.dumps(res, indent=1, default=str))
    return 0


def parallel_main() -> int:
    """``--parallel``: build, the references of phases 10 and 12, then
    phases 25-28 alone, details in chiprun_out/parallel.json."""
    import torch

    from satae_torch.config import (AETrainConfig, DataConfig,
                                    MLPTrainConfig, PipelineConfig)
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.kernels import _build

    check(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = DataConfig(per_class=2000, synthetic_difficulty="hard")
    raw = load_dataset(data)
    splits = make_splits(raw, data)
    fit_cfg = PipelineConfig(data=data, ae=AETrainConfig(max_epochs=2),
                             mlp=MLPTrainConfig(epochs=2))
    fit_ref = fit_phase(fit_cfg, raw, splits, "fit (phase 10's)",
                        repeat=False)
    grid_ref = grid_phase(card)
    res = parallel_phases(card, fit_cfg, raw, splits, data, fit_ref,
                          grid_ref)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "parallel.json").write_text(json.dumps(dict(
        card=card, phases=res), indent=1, default=str))
    return 0


# phase 30's shapes: Prithvi-EO-1.0-100M's encoder on a 64-chip serving
# chunk (589 tokens a chip, 12 heads of 64, width 768, MLP 3,072)
VIT_CHIPS, VIT_TOKENS, VIT_HEADS, VIT_DIM, VIT_MLP = 64, 589, 12, 768, 3072
VIT_ROWS = VIT_CHIPS * VIT_TOKENS
# its K1 launches (name, m, k, n, act)
VIT_GEMMS = (("patch", VIT_CHIPS * 588, 1536, VIT_DIM, "none"),
             ("qkv", VIT_ROWS, VIT_DIM, 3 * VIT_DIM, "none"),
             ("proj", VIT_ROWS, VIT_DIM, VIT_DIM, "none"),
             ("fc1", VIT_ROWS, VIT_DIM, VIT_MLP, "gelu"),
             ("fc2", VIT_ROWS, VIT_MLP, VIT_DIM, "none"))
# shapes at and around k1_wide's thresholds (m, k, n), each timed on both
# bf16 routes: K below WIDE_MIN_K (the decoder input's 64, and 128) and at
# it, tiles below one wave (48, 96) and above it (198)
VIT_THRESHOLDS = ((VIT_ROWS, 64, VIT_DIM), (VIT_ROWS, 128, VIT_DIM),
                  (VIT_ROWS, 256, VIT_DIM), (2048, VIT_DIM, VIT_DIM),
                  (4096, VIT_DIM, VIT_DIM), (8448, VIT_DIM, VIT_DIM))


def vit_kernels_phase(card: str) -> dict:
    """Phase 30a: the attention and LayerNorm kernels and K1 at the ViT's
    shapes (fc1 with GELU in its epilogue) against their plain versions on
    the same card (TF32 off), each timed (device us) beside its bound and a
    library yardstick: SDPA, F.layer_norm, bf16 torch.matmul. K1 on the
    wide route fused_gemm takes there (one bf16 ulp + 1e-6, >= 99 %
    bit-equal) and, for comparison, on the 64 x 64 wgmma route; then both
    routes at and around the wide route's thresholds (VIT_THRESHOLDS)."""
    import torch
    import torch.nn.functional as F

    from satae_torch.kernels import _build
    from satae_torch.kernels.attention import attention, attention_plain
    from satae_torch.kernels.layernorm import layer_norm, layer_norm_plain
    from satae_torch.kernels.matmul import (ACTS, fused_gemm,
                                            fused_gemm_wide,
                                            fused_matmul_plain, k1_wide,
                                            split_k_plan_tma)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(30)
    rows = []

    def k1_launch(lib, fn, a, wt, sh, act, lead, *ints):
        m, k = a.shape
        out = torch.empty(m, wt.shape[1], device=dev, dtype=a.dtype)
        _build.launch(_build.load(lib), fn, dev, a.data_ptr(), wt.data_ptr(),
                      0, sh.data_ptr(), out.data_ptr(), *lead, m,
                      wt.shape[1], k, ACTS.index(act), *ints)
        return out

    def k1_narrow(a, wt, sh, act):  # the 64 x 64 wgmma route, its plan
        _, _, splits, kps = split_k_plan_tma(a.shape[0], wt.shape[1],
                                             a.shape[1])
        return k1_launch("fused_gemm", "satae_fused_gemm_batched_bf16_tma",
                         a, wt, sh, act, (1,), 0, 0, splits, kps)

    def k1_wide_launch(a, wt, sh, act):  # the wide kernel, any shape it takes
        return k1_launch("gemm_wide", "satae_fused_gemm_bf16_wide", a, wt,
                         sh, act, ())
    # attention: a chunk's qkv at the scale a block's LayerNorm'd input
    # gives it, and the 589-key tail
    qkv = (torch.randn(VIT_ROWS, 3 * VIT_DIM, generator=g, device=dev)
           * 1.5).to(torch.bfloat16)
    out = attention(qkv, VIT_CHIPS, VIT_HEADS)
    ref = attention_plain(qkv, VIT_CHIPS, VIT_HEADS)
    err = (out.float() - ref.float()).abs()
    # the kernel rounds P to bf16 (2^-9 of each weight) before P V, so an
    # output's error scales with sum_j p_j |v_j| (the plain version on |v|),
    # not with the output, which may cancel; then the output's own rounding
    scale = attention_plain(
        torch.cat([qkv[:, :2 * VIT_DIM], qkv[:, 2 * VIT_DIM:].abs()], 1),
        VIT_CHIPS, VIT_HEADS).float()
    lim = bf16_ulp(ref) + scale * 2.0 ** -8 + 1e-6
    check(bool(torch.isfinite(out).all()), "attention: non-finite output")
    check(bool((err <= lim).all()), f"attention: max |err| "
          f"{float(err.max()):.3g}, {float((err / lim).max()):.3g} x the "
          "bound of one bf16 ulp + 2^-8 sum_j p_j |v_j|")
    check(torch.equal(out, attention(qkv, VIT_CHIPS, VIT_HEADS)),
          "attention: two calls differ")
    flops = 4.0 * VIT_CHIPS * VIT_HEADS * VIT_TOKENS ** 2 * 64
    nbytes = VIT_ROWS * 4 * VIT_DIM * 2.0
    b = bounds(flops, nbytes, bf16=True)
    us = device_us(lambda: attention(qkv, VIT_CHIPS, VIT_HEADS),
                   b["bound_ms"] * 1e3, "attention")
    q, k, v = qkv.view(VIT_CHIPS, VIT_TOKENS, 3, VIT_HEADS, 64) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    sdpa_us = device_us(lambda: F.scaled_dot_product_attention(q, k, v),
                        b["bound_ms"] * 1e3, "SDPA")
    rows.append(dict(kernel="attention", shape=[VIT_CHIPS, VIT_TOKENS,
                                                VIT_HEADS, 64],
                     max_abs_err=float(err.max()),
                     max_err_over_bound=float((err / lim).max()),
                     mean_abs_err=float(err.mean()),
                     bit_equal=float((out == ref).float().mean()),
                     device_us=us, sdpa_device_us=sdpa_us,
                     bound_us=b["bound_ms"] * 1e3, bound_by=b["bound_by"]))
    print(f"attention {VIT_CHIPS}x{VIT_TOKENS}x{VIT_HEADS}x64: "
          f"{us:.1f} us (SDPA {sdpa_us:.1f}, bound {b['bound_ms'] * 1e3:.1f}"
          f" by {b['bound_by']}), max |err| {float(err.max()):.3g}",
          flush=True)
    del qkv, out, ref, q, k, v, err, lim, scale
    # LayerNorm, plain and with the residual add
    x = (torch.randn(VIT_ROWS, VIT_DIM, generator=g, device=dev) * 3
         + 0.5).to(torch.bfloat16)
    r = torch.randn(VIT_ROWS, VIT_DIM, generator=g, device=dev) \
        .to(torch.bfloat16)
    w = torch.rand(VIT_DIM, generator=g, device=dev) + 0.5
    bb = torch.randn(VIT_DIM, generator=g, device=dev) * 0.1
    w16, b16 = w.bfloat16(), bb.bfloat16()
    for res in (False, True):
        xa, xb = x.clone(), x.clone()
        ha, ya = layer_norm(xa, w, bb, 1e-6, r if res else None)
        hb, yb = layer_norm_plain(xb, w, bb, 1e-6, r if res else None)
        check(torch.equal(ha, hb), f"layer_norm residual={res}: the sum "
              "differs from the plain version's")
        e, eq = ulp_err(ya, yb, f"layer_norm residual={res}")
        nbytes = VIT_ROWS * VIT_DIM * 2.0 * (4 if res else 2)
        b = bounds(10.0 * VIT_ROWS * VIT_DIM, nbytes, bf16=True)
        xc = x.clone()
        us = device_us(lambda: layer_norm(xc, w, bb, 1e-6,
                                          r if res else None),
                       b["bound_ms"] * 1e3, f"layer_norm residual={res}")
        lib_us = device_us(lambda: F.layer_norm(x, (VIT_DIM,), w16, b16,
                                                1e-6),
                           b["bound_ms"] * 1e3, "F.layer_norm")
        rows.append(dict(kernel="layer_norm", residual=res,
                         shape=[VIT_ROWS, VIT_DIM], max_abs_err=e,
                         bit_equal=eq, device_us=us,
                         f_layer_norm_device_us=lib_us,
                         bound_us=b["bound_ms"] * 1e3,
                         bound_by=b["bound_by"]))
        print(f"layer_norm {VIT_ROWS}x{VIT_DIM} residual={res}: {us:.1f} "
              f"us (F.layer_norm {lib_us:.1f}, bound "
              f"{b['bound_ms'] * 1e3:.1f}), bit-equal {eq:.5f}", flush=True)
    del x, r, xa, xb, xc, ha, hb, ya, yb
    # K1 at the ViT's shapes, fc1 with GELU: the wide route fused_gemm
    # takes (k1_wide), the 64 x 64 wgmma route beside it, launched directly
    for name, m, k, n, act in VIT_GEMMS:
        a = (torch.randn(m, k, generator=g, device=dev)).to(torch.bfloat16)
        wt = (torch.randn(k, n, generator=g, device=dev)
              / k ** 0.5).to(torch.bfloat16)
        sh = torch.randn(n, generator=g, device=dev) * 0.1
        check(k1_wide(a, wt), f"K1 {name}: not on the wide route")
        before = fused_gemm_wide.launches["_bf16"]
        out = fused_gemm(a, wt, None, sh, act)
        check(fused_gemm_wide.launches["_bf16"] == before + 1,
              f"K1 {name}: fused_gemm did not launch the wide kernel")
        ref = fused_matmul_plain(a, wt, None, sh, act)
        narrow = k1_narrow(a, wt, sh, act)
        # phase 30's bf16 K1 tolerance: one bf16 ulp + 1e-6, and for
        # outputs near 0 (a sum of up to 3,072 products that cancel) the two
        # float32 sums' orders, 2^-18 of the sum of the products'
        # magnitudes; at least 99 % bit-equal
        lim = bf16_ulp(ref) + 2.0 ** -18 * (a.float().abs()
                                            @ wt.float().abs())
        e, eq = ulp_err(out, ref, f"K1 wide {name} {act}", bound=lim)
        e_n, eq_n = ulp_err(narrow, ref, f"K1 64x64 {name} {act}", bound=lim)
        del lim
        check(torch.equal(out, fused_gemm(a, wt, None, sh, act)),
              f"K1 wide {name}: two calls differ")
        b = bounds(2.0 * m * k * n, (m * k + k * n + m * n) * 2.0,
                   bf16=True)
        us = device_us(lambda: fused_gemm(a, wt, None, sh, act),
                       b["bound_ms"] * 1e3, f"K1 wide {name}")
        narrow_us = device_us(lambda: k1_narrow(a, wt, sh, act),
                              b["bound_ms"] * 1e3, f"K1 64x64 {name}")
        lib_us = device_us(lambda: a @ wt, b["bound_ms"] * 1e3,
                           f"torch.matmul {name}")
        rows.append(dict(kernel="fused_gemm_bf16", layer=name, route="wide",
                         shape=[m, k, n], act=act, max_abs_err=e,
                         bit_equal=eq, bit_equal_64x64=eq_n,
                         max_abs_err_64x64=e_n,
                         equal_to_64x64=float((out == narrow).float().mean()),
                         device_us=us, device_us_64x64=narrow_us,
                         matmul_device_us=lib_us,
                         bound_us=b["bound_ms"] * 1e3,
                         bound_by=b["bound_by"]))
        print(f"K1 {name} {m}x{k}x{n} {act}: wide {us:.1f} us, 64x64 "
              f"{narrow_us:.1f} us, torch.matmul {lib_us:.1f} us, bound "
              f"{b['bound_ms'] * 1e3:.1f} ({b['bound_by']}); bit-equal the "
              f"plain version wide {eq:.5f} / 64x64 {eq_n:.5f}", flush=True)
        del a, wt, out, ref, narrow
    # both routes at and around the wide route's thresholds
    for m, k, n in VIT_THRESHOLDS:
        a = (torch.randn(m, k, generator=g, device=dev)).to(torch.bfloat16)
        wt = (torch.randn(k, n, generator=g, device=dev)
              / k ** 0.5).to(torch.bfloat16)
        sh = torch.randn(n, generator=g, device=dev) * 0.1
        wide = lambda: k1_wide_launch(a, wt, sh, "none")
        ref = fused_matmul_plain(a, wt, None, sh)
        e, eq = ulp_err(wide(), ref, f"K1 wide {m}x{k}x{n}", bound=(
            bf16_ulp(ref) + 2.0 ** -18 * (a.float().abs()
                                          @ wt.float().abs())))
        b = bounds(2.0 * m * k * n, (m * k + k * n + m * n) * 2.0,
                   bf16=True)
        us = device_us(wide, b["bound_ms"] * 1e3, f"K1 wide {m}x{k}x{n}")
        narrow_us = device_us(lambda: k1_narrow(a, wt, sh, "none"),
                              b["bound_ms"] * 1e3, f"K1 64x64 {m}x{k}x{n}")
        rows.append(dict(kernel="fused_gemm_bf16", layer="threshold",
                         shape=[m, k, n], picked=k1_wide(a, wt),
                         bit_equal=eq, device_us_wide=us,
                         device_us_64x64=narrow_us,
                         bound_us=b["bound_ms"] * 1e3))
        print(f"K1 threshold {m}x{k}x{n} (k1_wide {k1_wide(a, wt)}): wide "
              f"{us:.1f} us, 64x64 {narrow_us:.1f} us, bound "
              f"{b['bound_ms'] * 1e3:.1f}", flush=True)
        del a, wt, ref
    return {"card": card, "rows": rows}


def vit_serve_phase(card: str) -> dict:
    """Phase 30b: Prithvi-EO-1.0-100M's encoder and the pipeline's MLP served
    through SatAEPipeline.predict on 256 int16 chips (4 chunks of 64, page
    -locked): exact launch counts (K1 49 bf16 + 3 float32, attention 12 and
    LayerNorm 25 a chunk, nothing else of the port), no SDPA or
    F.layer_norm kernel in the profile of a call, the latents of 16 chips
    against the plain float32 reference of tests/prithvi_reference.py, the
    served classes against its logits, and the calls timed."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO / "tests"))
    import prithvi_reference as PR
    from satae_torch import config as C
    from satae_torch import kernels
    from satae_torch.api import SatAEPipeline

    vc = C.PRITHVI_EO1_100M
    cfg = {k: getattr(vc, k) for k in (
        "img_size", "patch_size", "num_frames", "tubelet_size", "in_chans",
        "embed_dim", "depth", "num_heads", "mlp_ratio", "norm_eps")}
    vc = C.ViTConfig(band_mean=(5000.0,) * 6, band_std=(2886.75,) * 6)
    p = PR.init_params(cfg, 30)
    hp = PR.head_init([768, 128, 64, 10], 31)
    n = 256
    rng = np.random.default_rng(30)
    # chips that differ: a level and a texture per chip and band
    base = rng.uniform(500, 9000, (n, 6, 1, 1, 1))
    tex = rng.normal(0, 800, (n, 6, 3, 224, 224))
    chips = np.clip(base + tex, 0, 10000).astype(np.int16)
    host = torch.from_numpy(chips).pin_memory()
    pc = C.PipelineConfig(
        data=C.DataConfig(batch_size=8),
        model=C.ModelConfig(latent_dim=768),
        runtime=C.RuntimeConfig(compute_dtype="bfloat16"))
    pipe = SatAEPipeline(pc, device="cuda", encoder=vc).load_torch(p, hp)
    pipe.predict(host.numpy())
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    preds = pipe.predict(host.numpy())
    got = kernels.launch_counts()
    want = counts(fused_gemm_bf16=4 * 49, fused_gemm=4 * 3,
                  fused_gemm_wide_bf16=4 * 49, attention_bf16=4 * 12,
                  layer_norm_bf16=4 * 25)
    check(got == want, f"ViT predict launches {got}, expected {want}")
    records, _ = device_records(lambda: pipe.predict(host.numpy()), 1,
                                pad_s=0.05, warm=True)
    names = sorted({e.name for e in records})
    banned = [nm for nm in names if any(b in nm.lower() for b in (
        "flash", "fmha", "attention_kernel_", "efficient_attention",
        "layer_norm_kernel", "layernorm_kernel"))
        and "satae" not in nm]
    check(not banned, f"library kernels on the ViT path: {banned}")
    with PR.no_tf32():
        sel = torch.from_numpy(chips[:16]).cuda()
        dp = {k: v.cuda() for k, v in p.items()}
        dh = {k: v.cuda() for k, v in hp.items()}
        z_ref = PR.latents(dp, cfg, sel, vc.band_mean, vc.band_std)
        lg_ref = torch.cat([PR.head_logits(dh, PR.latents(
            dp, cfg, torch.from_numpy(chips[i:i + 32]).cuda(), vc.band_mean,
            vc.band_std)) for i in range(0, n, 32)]).cpu().numpy()
    z = torch.from_numpy(pipe.encode(chips[:16])).cuda()
    rel = float(((z - z_ref).norm(dim=1) / z_ref.norm(dim=1)).max())
    gap = float((lg_ref.max(1) - np.take_along_axis(
        lg_ref, preds[:, None].astype(np.int64), 1)[:, 0]).max())
    agree = float((preds == lg_ref.argmax(1)).mean())
    print(f"ViT predict: launches {got}; latent worst relative L2 gap "
          f"{rel:.4g}; logit gap {gap:.4g}; classes agreeing {agree:.4f}",
          flush=True)
    check(rel < 0.05, f"ViT latents {rel:.4g} off the float32 reference")
    ms = time_ms(lambda: pipe.predict(host.numpy()), reps=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    print(f"ViT predict of {n} chips: {ms:.2f} ms a call, "
          f"{n / ms * 1e3:.0f} chips/s, {256 * 114.23e9 / (ms * 1e-3) / 989e12 * 100:.1f} % "
          f"of bf16 peak; memory peak {peak / 1e9:.2f} GB", flush=True)
    device_ops = collections.Counter()
    for e in records:
        device_ops[e.name[:100]] += (e.time_range.end - e.time_range.start)
    return {"launches": got, "kernel_names": names[:40],
            "latent_rel_l2": rel, "logit_gap": gap, "agree": agree,
            "call_ms": ms, "memory_peak_bytes": peak,
            "device_us_by_op": device_ops.most_common(15)}


def vit_main() -> int:
    """The build and phase 30 (the ViT encoder's kernels and its serving)
    alone -> chiprun_out/vit.json."""
    import torch

    from satae_torch.kernels import _build

    check(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    report = _build.ptxas_report()
    for r in report:
        if "fused_gemm_tma_kernel" in r["kernel"]:
            print(f"  ptxas {r['kernel']}: {r['registers']} registers",
                  flush=True)
    check(len(report) == N_INSTANTIATIONS, f"{len(report)} kernel "
          f"instantiations in the ptxas report, expected {N_INSTANTIATIONS}")
    ptxas = [r for r in report
             if r["source"] in ("attention", "layernorm", "gemm_wide")]
    for r in ptxas:
        print(f"  ptxas {r['kernel']}: {r['registers']} registers, "
              f"{r['smem']} B static shared memory, spills "
              f"{r['spill_stores']} B stored / {r['spill_loads']} B loaded",
              flush=True)
    # checked after the phase, whose times a failed build still reports
    spilled = len(ptxas) != 6 or any(r["spill_stores"] or r["spill_loads"]
                                     for r in ptxas)
    log = (_build.build_dir() / "gemm_wide.log").read_text()
    notes = [ln.strip() for ln in log.splitlines()
             if "C75" in ln or "setmaxnreg" in ln]
    print(f"  ptxas notes of the wide K1: {notes or 'none'}", flush=True)
    if spilled:  # where: the SASS around each local-memory access
        tool = str(Path(_build.nvcc_path()).parent / "cuobjdump")
        sass = subprocess.run(
            [tool, "-sass", str(_build.build_all()["gemm_wide"])],
            capture_output=True, text=True, timeout=300).stdout.splitlines()
        for i, ln in enumerate(sass):
            if "Function :" in ln or "STL" in ln or "LDL" in ln:
                near = sass[max(i - 2, 0):i + 2]
                print("  sass " + " | ".join(x.strip()[:60] for x in near),
                      flush=True)
    hgmma = {k: v for k, v in hgmma_counts().items() if "wide" in k}
    print(f"  SASS HGMMA of the wide K1: {hgmma}", flush=True)
    check(len(hgmma) == 4 and all(hgmma.values()),
          f"wide K1 instantiations with HGMMA: {hgmma}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card, "ptxas": ptxas, "ptxas_notes": notes}
    from satae_torch.kernels.matmul import fused_gemm
    a32 = torch.ones(64, 64, device="cuda")
    try:
        fused_gemm(a32, a32, None, None, "gelu")
        check(False, "a float32 K1 launch with GELU was not refused")
    except ValueError:
        pass
    out["kernels"] = vit_kernels_phase(card)
    out["serve"] = vit_serve_phase(card)
    path = REPO / "chiprun_out" / "vit.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    check(not spilled, f"attention / LayerNorm / wide K1: {ptxas}")
    check(not notes, f"wide K1: ptxas serialised its wgmmas or ignored "
          f"setmaxnreg: {notes}")
    print(json.dumps({"ok": True, "card": card}), flush=True)
    return 0


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def f32_digests(fused_gemm, conv) -> dict:
    """{case: sha256 of the output} of the float32 K1 and the K2 of module
    ``conv`` at the shapes of phases 3 and 4 (K1's split shapes in every
    layout), all activations, on inputs drawn from a fixed seed, each conv
    weight in the tree's own float32 layout (:func:`f32_conv_args`): equal
    digests in two trees are bitwise equal outputs."""
    import hashlib

    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, device=dev, generator=g) * (hi - lo) + lo

    def digest(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    out = {}
    for (m, k, n), layouts in itertools.chain(
            ((s, ((False, False),)) for s in K1_SHAPES),
            ((s, LAYOUTS) for s in SPLIT_SHAPES)):
        a = torch.randn(m, k, device=dev, generator=g)
        b = rand(k, n, lo=-1.0, hi=1.0) / k ** 0.5
        scale, shift = rand(n, lo=0.5, hi=1.5), rand(n, lo=-0.3, hi=0.3)
        for ta, tb in layouts:
            a_buf = a.t().contiguous() if ta else a
            b_buf = b.t().contiguous() if tb else b
            for act in ACTS:
                out[f"K1 {(m, k, n)} {ta} {tb} {act}"] = digest(fused_gemm(
                    a_buf, b_buf, scale, shift, act, ta, tb))
    for n, hw, cin, cout in K2_SHAPES:
        x = rand(n, hw, hw, cin)
        w, kw_ = f32_conv_args(conv, rand(3, 3, cin, cout, lo=-1.0, hi=1.0)
                               / (9 * cin) ** 0.5)
        scale, shift = rand(cout, lo=0.5, hi=1.5), rand(cout, lo=-0.3, hi=0.3)
        for act in (("relu",) if n == CHUNK else ACTS):
            out[f"K2 {(n, hw, cin, cout)} {act}"] = digest(
                conv.conv2d_bn_act(x, w, scale, shift, 2, 1, act, **kw_))
    return out


def batched_rows(matmul, outputs: dict, digests: dict) -> list:
    """The --ab rows of the batched K1 (a tree's ``fused_gemm`` on 3-D
    stacks, or its ``fused_gemm_batched`` where it has one):
    every launch of phase 21 (:func:`batched_products`, C = 45 AE and 11
    MLP) in float32 and bf16 on phase 21's inputs, back-to-back ms and
    device us per launch; each output goes into ``outputs`` and each
    float32 output's sha256 into ``digests``, under (kernel, path, layer).
    The route is the tree's loader where its batched K1 has a TMA route
    (split_k_plan_tma takes ``batch``), else the mma.sync loop."""
    import hashlib
    import inspect

    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    has_tma = "batch" in inspect.signature(
        getattr(matmul, "split_k_plan_tma", lambda: None)).parameters
    gemm = getattr(matmul, "fused_gemm_batched", matmul.fused_gemm)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        bf16 = dt == torch.bfloat16
        for path, layer, prod, (m, k, n), ta, tb, act in batched_products():
            c = VMAP_C[path]
            a = torch.randn(c, *((k, m) if ta else (m, k)), device=dev,
                            generator=g).to(dt)
            b = ((torch.rand(c, *((n, k) if tb else (k, n)), device=dev,
                             generator=g) * 2 - 1) / k ** 0.5).to(dt)
            shift = torch.randn(c, n, device=dev, generator=g) * 0.3 \
                if prod == "fwd" else None
            run = lambda: gemm(a, b, None, shift, act, ta, tb)
            name = "fused_gemm_batched" + ("" if prod == "fwd" else "_bwd") \
                + ("_bf16" if bf16 else "")
            key = (name, path, f"{layer} {prod}")
            out = run()
            torch.cuda.synchronize()
            outputs[key] = out.cpu()
            if not bf16:
                digests["|".join(key)] = hashlib.sha256(
                    out.cpu().numpy().tobytes()).hexdigest()
            nbytes = a.element_size() * c * (m * k + k * n + m * n)
            bnd = bounds(2.0 * c * m * n * k, nbytes, bf16)
            rows.append(dict(
                kernel=name, path=path, layer=key[2], shape=[c, m, k, n],
                trans=[ta, tb], dtype="bf16" if bf16 else "float32",
                route=(tree_k1_route(matmul, a, b, ta, tb) if has_tma
                       else "cp.async"),
                ms=time_ms(run, reps=50), device_us=device_us(
                    run, bnd["bound_ms"] * 1e3, " ".join(key)), **bnd))
    return rows


def kernel_times_main(root: str, out_file: str) -> int:
    """The --ab child: :func:`kernel_rows` on the kernels of the satae_torch
    under ``root`` (float32, on the tree's own serving fold layouts, and
    bf16 where that tree has the bf16 instantiations), :func:`batched_rows`
    where it has the batched K1 and :func:`f32_digests` (with the float32
    batched outputs' digests), as one JSON line; every launch's output goes
    to ``out_file`` (torch.save)."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    root_ = Path(root).resolve()
    sys.path.insert(0, str(root_))
    import satae_torch
    from satae_torch.kernels import _build, conv, matmul

    pkg = Path(satae_torch.__file__).resolve()
    check(pkg.is_relative_to(root_), f"satae_torch came from {pkg}, not "
          f"from {root_}")
    mods = SimpleNamespace(fused_gemm=matmul.fused_gemm,
                           conv2d_bn_act=conv.conv2d_bn_act,
                           k_major=hasattr(conv, "is_k_major"), conv=conv)
    for fn in ("k1_loader", "k1_wide", "conv_route"):  # where it has them
        for mod in (matmul, conv):
            if hasattr(mod, fn):
                setattr(mods, fn, getattr(mod, fn))
    outputs = {}
    rows = kernel_rows(mods, reference=False, outputs=outputs)
    if torch.bfloat16 in getattr(_build, "OPERAND_DTYPES", {}):
        rows += kernel_rows(mods, reference=False, bf16=True,
                            outputs=outputs)
    digests = f32_digests(matmul.fused_gemm, conv)
    if "satae_fused_gemm_batched" in _build.LAUNCHERS["fused_gemm"]:
        rows += batched_rows(matmul, outputs, digests)
    torch.save({"|".join(k): v for k, v in outputs.items()}, out_file)
    print(json.dumps(dict(rows=rows, digests=digests)), flush=True)
    return 0


# --ab's serving comparison: windows of PREDICT_WINDOW calls, PREDICT_PAIRS
# pairs of them in alternating order
PREDICT_WINDOW = 20
PREDICT_PAIRS = 12


def predict_worker_main(root: str) -> int:
    """The --ab serving child of the tree at ``root``: the committed float32
    model and 2,990 random uint8 images; after a warm-up it prints "ready",
    then for each "go" line on its input times one window -- PREDICT_WINDOW
    calls of ``predict`` (the pageable upload and the readback included)
    and PREDICT_WINDOW runs of the same serving path on the images already
    on the device (the fold's K2 and K1 launches chunk by chunk and the
    argmax, between CUDA events) -- and prints both rates as one JSON
    line; for "host" it prints the host's time to issue one call of the
    device-resident path and one of each of its layers (queued behind a
    spin kernel, so the card never waits for it), us; anything else ends
    it."""
    import numpy as np
    import torch

    root_ = Path(root).resolve()
    sys.path.insert(0, str(root_))
    import satae_torch
    from satae_torch.api import SatAEPipeline
    from satae_torch.config import DataConfig, PipelineConfig
    from satae_torch.data.augment import normalize
    from satae_torch.models import fast_infer

    check(Path(satae_torch.__file__).resolve().is_relative_to(root_),
          f"satae_torch came from {satae_torch.__file__}, not from {root_}")
    pipe = SatAEPipeline(PipelineConfig(data=DataConfig(
        synthetic_difficulty="hard"))).load(str(CKPT))
    imgs = np.random.default_rng(0).integers(0, 256, (2990, 64, 64, 3),
                                             dtype=np.uint8)
    n = len(imgs)
    chunk = pipe._serve_chunk(n)
    dev = torch.zeros((n + (-n) % chunk, 64, 64, 3), dtype=torch.uint8,
                      device="cuda")
    dev[:n].copy_(torch.from_numpy(imgs))
    dtype = pipe.config.compute_dtype

    @torch.no_grad()
    def on_device():
        fe, fm = pipe._folded_weights()
        return [torch.argmax(fast_infer.mlp_infer(fm, fast_infer.encoder_infer(
            fe, normalize(dev[lo:lo + chunk], dtype)).float()), dim=-1)
            for lo in range(0, len(dev), chunk)]

    check(np.array_equal(torch.cat(on_device()).cpu().numpy()[:n],
                         pipe.predict(imgs)),
          "the device-resident path differs from predict")
    for _ in range(3):
        pipe.predict(imgs)
        on_device()
    torch.cuda.synchronize()
    print("ready", flush=True)

    def host_us(fn, reps):  # host time to issue one call, card held busy
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 27)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return dt

    for line in sys.stdin:
        if line.strip() == "host":
            fe, fm = pipe._folded_weights()
            h, layers = normalize(dev[:chunk], dtype), {}
            for i, c in enumerate(fe.convs):
                kw_ = {} if getattr(c, "w_tf32", None) is None else dict(
                    w_tf32=c.w_tf32)
                layers[f"conv{i}"] = functools.partial(
                    fast_infer.conv2d_bn_act, h, c.w, c.scale, c.shift,
                    c.stride, c.padding, "relu", **kw_)
                h = layers[f"conv{i}"]()
            h = h.reshape(h.shape[0], -1)
            for name, lay in [("proj", fe.proj)] + [
                    (f"fc{i}", lay) for i, lay in enumerate(fm.layers)]:
                layers[name] = functools.partial(lay, h)
                h = lay(h).float()
            out = {name: host_us(fn, 50) for name, fn in layers.items()}
            out["call"] = host_us(on_device, 5)
            print(json.dumps(out), flush=True)
            continue
        if line.strip() != "go":
            break
        t0 = time.perf_counter()
        for _ in range(PREDICT_WINDOW):
            pipe.predict(imgs)
        predict_s = (time.perf_counter() - t0) / PREDICT_WINDOW
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(PREDICT_WINDOW):
            on_device()
        end.record()
        end.synchronize()
        device_s = start.elapsed_time(end) / 1e3 / PREDICT_WINDOW
        print(json.dumps(dict(predict_images_per_s=n / predict_s,
                              device_images_per_s=n / device_s)), flush=True)
    return 0


def predict_pairs(parent: str, tmp: Path) -> dict:
    """Each tree's float32 serving of the committed model in one long-lived
    process (:func:`predict_worker_main`), the two processes timed in turn:
    PREDICT_PAIRS pairs of windows, parent first in the even pairs and the
    change first in the odd ones. Returns each tree's rates (predict and
    device-resident, images/s) with their medians and quartiles, and the
    median of the pairs' change / parent ratios."""
    import statistics

    procs = {}
    for label, root in (("parent", parent), ("change", REPO)):
        err = open(tmp / f"predict_{label}.err", "w")
        procs[label] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--predict-worker", str(root)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=err, text=True), err)

    def read(label, want):  # the worker's next line that starts with want
        proc, err = procs[label]
        while True:
            line = proc.stdout.readline()
            if not line:
                err.flush()
                check(False, f"predict worker {label} ended:\n" + (
                    tmp / f"predict_{label}.err").read_text()[-4000:])
            if line.startswith(want):
                return line.strip()

    try:
        for label in procs:
            read(label, "ready")
        rates = {label: [] for label in procs}
        for i in range(PREDICT_PAIRS):
            for label in (("parent", "change") if i % 2 == 0
                          else ("change", "parent")):
                procs[label][0].stdin.write("go\n")
                procs[label][0].stdin.flush()
                rates[label].append(json.loads(read(label, "{")))
        host = {}
        for label in procs:
            procs[label][0].stdin.write("host\n")
            procs[label][0].stdin.flush()
            host[label] = json.loads(read(label, "{"))
    finally:
        for proc, err in procs.values():
            if proc.poll() is None:
                proc.stdin.close()
                proc.wait(timeout=60)
            err.close()
    out = {}
    for metric in ("predict_images_per_s", "device_images_per_s"):
        per = {label: [r[metric] for r in rates[label]] for label in rates}
        q = {label: statistics.quantiles(v, n=4) for label, v in per.items()}
        out[metric] = dict(
            runs=per, median={k: q[k][1] for k in q},
            quartiles={k: [q[k][0], q[k][2]] for k in q},
            pair_ratio_median=statistics.median(
                c / p for c, p in zip(per["change"], per["parent"])))
    out["host_us"] = host
    return out


def ab_main(parent: str) -> int:
    """Every K1 and K2 launch that both trees have, timed in the tree at
    ``parent`` and in this one, in turns parent, this, this, parent, one
    process each; the float32 outputs at the shapes of phases 3 and 4 (and
    phase 21's batched ones) must be bitwise equal in all four runs, and so
    must every timed float32 launch's. For each launch the share of its
    outputs bitwise equal to the parent tree's, beside both trees' device
    us (each tree's two runs must agree bitwise). Then each tree's float32
    serving of the committed model in alternating windows
    (:func:`predict_pairs`)."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    check((Path(parent) / "satae_torch").is_dir(),
          f"{parent} holds no satae_torch")
    import tempfile

    card = card_line()
    print(card, flush=True)
    runs = []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ab_"))
    for i, (label, root) in enumerate((("parent", parent), ("change", REPO),
                                       ("change", REPO),
                                       ("parent", parent))):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kernel-times",
             str(root), str(tmp / f"{i}.pt")], capture_output=True, text=True,
            timeout=900)
        check(res.returncode == 0, f"kernel times in {root} failed:\n"
              f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        runs.append(dict(label=label, root=str(root),
                         seconds=time.perf_counter() - t0,
                         **json.loads(res.stdout.strip().splitlines()[-1])))
        print(f"{label} ({root}): {runs[-1]['seconds']:.1f} s", flush=True)
    digests = runs[0]["digests"]
    differ = [c for c in digests
              if any(r["digests"].get(c) != digests[c] for r in runs[1:])]
    print(f"float32 K1 and K2 outputs at the shapes of phases 3 and 4, and "
          f"the float32 batched K1's at phase 21's: {len(digests) - len(differ)}"
          f" of {len(digests)} cases bitwise equal in all four runs",
          flush=True)
    check(not differ and all(len(r["digests"]) == len(digests)
                             for r in runs),
          f"float32 outputs differ from the parent tree's: {differ}")
    key = lambda r: (r["kernel"], r["path"], r["layer"])
    by_run = [{key(r): r for r in run["rows"]} for run in runs]
    both = [k for k in by_run[1] if k in by_run[0]]
    print("device us per launch: parent (1st, 4th run) | change (2nd, 3rd) "
          "| change / parent; back-to-back ms the same way", flush=True)
    for k in both:
        par = [by_run[j][k] for j in (0, 3)]
        chg = [by_run[j][k] for j in (1, 2)]
        us_p = sum(x["device_us"] for x in par) / 2
        us_c = sum(x["device_us"] for x in chg) / 2
        print(f"  {k[0]:26s} {k[1]:5s} {k[2]:10s} "
              f"{str(chg[0]['shape']):24s} us {par[0]['device_us']:.1f} "
              f"{par[1]['device_us']:.1f} | {chg[0]['device_us']:.1f} "
              f"{chg[1]['device_us']:.1f} | {us_c / us_p:.3f};  ms "
              f"{par[0]['ms']:.4f} {par[1]['ms']:.4f} | {chg[0]['ms']:.4f} "
              f"{chg[1]['ms']:.4f}", flush=True)
    only = [k for k in by_run[1] if k not in by_run[0]]
    print(f"launches in this tree only, not timed: {only}", flush=True)
    serve = predict_pairs(parent, tmp)
    print("host us to issue one call of the device-resident serving path "
          "and each of its layers, parent | change: " + ", ".join(
              f"{k} {serve['host_us']['parent'][k]:.1f} | "
              f"{serve['host_us']['change'][k]:.1f}"
              for k in serve["host_us"]["change"]), flush=True)
    for metric, r in ((k, v) for k, v in serve.items() if k != "host_us"):
        print(f"float32 {metric} of the committed model, 2,990 images, "
              f"{PREDICT_PAIRS} alternating pairs of {PREDICT_WINDOW}-call "
              f"windows: median (quartiles) parent {r['median']['parent']:.1f}"
              f" ({r['quartiles']['parent'][0]:.1f}-"
              f"{r['quartiles']['parent'][1]:.1f}) | change "
              f"{r['median']['change']:.1f} ({r['quartiles']['change'][0]:.1f}"
              f"-{r['quartiles']['change'][1]:.1f}) | median of the pairs' "
              f"change / parent {r['pair_ratio_median']:.4f}", flush=True)
    # the share of each launch's outputs bitwise equal to the parent's,
    # beside both trees' device us; each tree against itself
    outs = [torch.load(tmp / f"{i}.pt") for i in range(4)]
    shutil.rmtree(tmp, ignore_errors=True)
    equal = {}
    print("launches: share of outputs bitwise equal to the parent's | "
          "device us parent, change (means of two runs each); every one "
          "held at 1", flush=True)
    for key in outs[1]:
        k = tuple(key.split("|"))
        if key not in outs[0] or k not in by_run[0]:
            continue
        share = float((outs[1][key] == outs[0][key]).float().mean())
        check(torch.equal(outs[0][key], outs[3][key])
              and torch.equal(outs[1][key], outs[2][key]),
              f"{key}: two runs of one tree differ bitwise")
        us_p = sum(by_run[j][k]["device_us"] for j in (0, 3)) / 2
        us_c = sum(by_run[j][k]["device_us"] for j in (1, 2)) / 2
        equal[key] = dict(share_equal=share, parent_us=us_p, change_us=us_c,
                          route=by_run[1][k].get("route"),
                          parent_route=by_run[0][k].get("route"))
        check(share == 1.0, f"{key}: {share} of its outputs bitwise the "
              "parent's (no launch --ab times takes K1's wide route)")
        check(by_run[1][k].get("route") != "wide",
              f"{key}: a launch of the autoencoder's paths on the wide "
              "route")
        print(f"  {k[0]:26s} {k[1]:6s} {k[2]:10s} "
              f"{by_run[1][k].get('route') or '':8s} equal {share:.6f} | "
              f"us {us_p:.1f} -> {us_c:.1f}", flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab.json").write_text(json.dumps(dict(
        card=card, runs=runs, differ=differ, equal=equal, serve=serve),
        indent=1))
    return 0


def split_sweep_main() -> int:
    """K1's device us per launch at the long-K products for each split count
    and tile width, launched with that plan directly: float32 on 32- and
    64-wide tiles (split_k_plan's basis), and the bf16 TMA route for each
    cluster size it takes (split_k_plan_tma's basis), each held against the
    plain version (float32 within 1e-4 + 1e-5*|ref|, bf16 within one bf16
    ulp + 1e-6 and >= 99 % bit-equal)."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    from satae_torch.kernels import _build
    from satae_torch.kernels.matmul import (BK, MAX_CLUSTER, TMA_BK,
                                            TMA_BK_F32, _tile_counters,
                                            fused_matmul_plain, split_k_plan,
                                            split_k_plan_tma)

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
        floor_us = 4.0 * (m * k + k * n + m * n) / HBM_PEAK * 1e6
        lib_us = device_us(lambda: torch.matmul(a, bv), floor_us,
                           f"torch.matmul {(m, k, n)}", 50)
        print(f"K1 {(m, k, n)} trans_b={tb}: plan {split_k_plan(m, n, k)}, "
              f"torch.matmul {lib_us:.1f} us", flush=True)
        for tile_n in (32, 64):
            for want in (1, 2, 4, 8, 16, 32, 64):
                kps = -(-(-(-k // want)) // BK) * BK
                splits = -(-k // kps)
                out = torch.empty(m, n, device=dev)
                ws = torch.empty(splits * m * n, device=dev)
                run = lambda: _build.launch(
                    lib, "satae_fused_gemm_batched", dev, a.data_ptr(),
                    b.data_ptr(), 0, 0, out.data_ptr(), ws.data_ptr(),
                    counters.data_ptr(), 1, m, n, k, 0, 0, int(tb), tile_n,
                    splits, kps)
                run()
                err = max_err(out, ref, f"K1 {(m, k, n)} tile_n {tile_n} "
                              f"{splits} splits")
                us = device_us(run, floor_us, f"K1 {(m, k, n)} tile_n "
                               f"{tile_n} {splits} splits", 50)
                rows.append(dict(dtype="float32", shape=[m, k, n],
                                 trans_b=tb, tile_n=tile_n, splits=splits,
                                 k_per_split=kps, device_us=us,
                                 max_abs_err=err, library_device_us=lib_us))
                print(f"  tile 64x{tile_n}, {splits:2d} splits of {kps:4d}: "
                      f"{us:7.1f} us  max |err| {err:.3g}", flush=True)
        # float32 (3xTF32) on the wgmma route: one cluster per tile, of
        # `splits` blocks, or of up to 16 holding several partials each
        print(f"float32 wgmma K1 {(m, k, n)} trans_b={tb}: plan "
              f"{split_k_plan_tma(m, n, k, dtype=torch.float32)}", flush=True)
        for want in (1, 2, 4, 8, 11, 16, 32, 64):
            kps = -(-(-(-k // want)) // TMA_BK_F32) * TMA_BK_F32
            splits = -(-k // kps)
            out = torch.empty(m, n, device=dev)
            run = lambda: _build.launch(
                lib, "satae_fused_gemm_batched_tma", dev, a.data_ptr(),
                b.data_ptr(), 0, 0, out.data_ptr(), 1, m, n, k, 0, 0,
                int(tb), splits, kps)
            run()
            err = max_err(out, ref, f"float32 wgmma K1 {(m, k, n)} {splits} "
                          "splits")
            us = device_us(run, floor_us, f"float32 wgmma K1 {(m, k, n)} "
                           f"{splits} splits", 50)
            rows.append(dict(dtype="float32", route="tma", shape=[m, k, n],
                             trans_b=tb, tile_n=64, splits=splits,
                             k_per_split=kps, device_us=us, max_abs_err=err,
                             library_device_us=lib_us))
            print(f"  float32 tile 64x64, cluster of {splits:2d} splits of "
                  f"{kps:4d}: {us:7.1f} us  max |err| {err:.3g}", flush=True)
        # bf16 on the TMA route: one cluster of `splits` blocks per tile
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ref16 = fused_matmul_plain(a16, b16.t() if tb else b16, None,
                                   torch.zeros(n, device=dev))
        lib16_us = device_us(lambda: torch.matmul(a16, b16.t() if tb else b16),
                             floor_us / 2, f"bf16 torch.matmul {(m, k, n)}",
                             50)
        print(f"bf16 K1 {(m, k, n)} trans_b={tb}: plan "
              f"{split_k_plan_tma(m, n, k)}, torch.matmul {lib16_us:.1f} us",
              flush=True)
        for want in (1, 2, 4, 8, 16):
            kps = -(-(-(-k // want)) // TMA_BK) * TMA_BK
            splits = -(-k // kps)
            if splits > MAX_CLUSTER:
                continue
            out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
            run = lambda: _build.launch(
                lib, "satae_fused_gemm_batched_bf16_tma", dev, a16.data_ptr(),
                b16.data_ptr(), 0, 0, out.data_ptr(), 1, m, n, k, 0, 0,
                int(tb), splits, kps)
            run()
            err, eq = ulp_err(out, ref16, f"bf16 K1 {(m, k, n)} {splits} "
                              "splits")
            us = device_us(run, floor_us / 2, f"bf16 K1 {(m, k, n)} "
                           f"{splits} splits", 50)
            rows.append(dict(dtype="bf16", shape=[m, k, n], trans_b=tb,
                             tile_n=64, splits=splits, k_per_split=kps,
                             device_us=us, max_abs_err=err, bit_equal=eq,
                             library_device_us=lib16_us))
            print(f"  bf16 tile 64x64, cluster of {splits:2d} splits of "
                  f"{kps:4d}: {us:7.1f} us  max |err| {err:.3g}, bit-equal "
                  f"{eq:.5f}", flush=True)
    rows += batched_split_sweep(lib, dev, g)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "split_sweep.json").write_text(json.dumps(
        dict(card=card, rows=rows), indent=1))
    return 0


def batched_split_sweep(lib, dev, g) -> list:
    """--split-sweep at the vmap path's two long-K launches, the projection
    forward (B an (N, K) weight) and the decoder input's dX (B a (K, N)
    weight), 64 x 4096 x 64 at C = 45, float32 and bf16: the batched wgmma
    route for every cluster size 1-16 that a split of whole stages gives
    (split_k_plan_tma's batched basis), each held to its plain version per
    config, beside the batched mma.sync launch on split_k_plan's plan and
    torch.bmm in the same dtype (TF32 off)."""
    import torch

    from satae_torch.kernels import _build
    from satae_torch.kernels.matmul import (MAX_CLUSTER, TMA_BK, TMA_BK_F32,
                                            _tile_counters, fused_matmul_plain,
                                            split_k_plan, split_k_plan_tma)

    c, m, k, n = VMAP_C["ae"], BATCH, 4096, 64
    rows = []
    for (layer, tb), dt in itertools.product(
            (("proj fwd", True), ("dec_in dX", False)),
            (torch.float32, torch.bfloat16)):
        bf16 = dt == torch.bfloat16
        name, sfx = ("bf16", "_bf16") if bf16 else ("float32", "")
        floor_us = (2.0 if bf16 else 4.0) * c * (m * k + k * n + m * n) \
            / HBM_PEAK * 1e6
        depth = TMA_BK if bf16 else TMA_BK_F32
        a = torch.randn(c, m, k, device=dev, generator=g).to(dt)
        b = ((torch.rand(c, *((n, k) if tb else (k, n)), device=dev,
                         generator=g) * 2 - 1) / k ** 0.5).to(dt)
        bv = b.transpose(1, 2) if tb else b
        zeros = torch.zeros(n, device=dev)
        ref = torch.stack([fused_matmul_plain(a[i], bv[i], None, zeros)
                           for i in range(c)])
        lib_us = device_us(lambda: torch.bmm(a, bv), floor_us / 2,
                           f"{name} torch.bmm C={c} {(m, k, n)}", 50)
        _, tile_n, s0, kps0 = split_k_plan(m, n, k, batch=c)
        out = torch.empty(c, m, n, device=dev, dtype=dt)
        ws = torch.empty(c * s0 * m * n, device=dev)
        counters = _tile_counters(dev)
        mma_us = device_us(lambda: _build.launch(
            lib, "satae_fused_gemm_batched" + sfx, dev, a.data_ptr(),
            b.data_ptr(), 0, 0, out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), c, m, n, k, 0, 0, int(tb), tile_n, s0, kps0),
            floor_us, f"{name} batched mma.sync C={c} {layer}", 50)
        print(f"{name} batched K1 C={c} {layer} {(m, k, n)} trans_b={tb}: "
              f"plan {split_k_plan_tma(m, n, k, batch=c, dtype=dt)}, "
              f"torch.bmm {lib_us:.1f} us, mma.sync ({s0} splits of {kps0}) "
              f"{mma_us:.1f} us", flush=True)
        seen = set()
        for want in range(1, MAX_CLUSTER + 1):
            kps = -(-(-(-k // want)) // depth) * depth
            splits = -(-k // kps)
            if splits in seen:
                continue
            seen.add(splits)
            out = torch.empty(c, m, n, device=dev, dtype=dt)
            run = lambda: _build.launch(
                lib, f"satae_fused_gemm_batched{sfx}_tma", dev, a.data_ptr(),
                b.data_ptr(), 0, 0, out.data_ptr(), c, m, n, k, 0, 0,
                int(tb), splits, kps)
            run()
            what = f"{name} batched K1 C={c} {layer} {splits} splits"
            if bf16:
                err, eq = ulp_err(out, ref, what)
            else:
                err, eq = max_err(out, ref, what), None
            us = device_us(run, floor_us, what, 50)
            rows.append(dict(dtype=name, batch=c, layer=layer,
                             shape=[m, k, n], trans_b=tb, tile_n=64,
                             splits=splits, k_per_split=kps, device_us=us,
                             max_abs_err=err, bit_equal=eq,
                             library_device_us=lib_us,
                             mma_sync_device_us=mma_us))
            print(f"  C={c} cluster of {splits:2d} splits of {kps:4d} "
                  f"({c * splits} blocks): {us:7.1f} us  max |err| "
                  f"{err:.3g}" + ("" if eq is None else
                                  f", bit-equal {eq:.5f}"), flush=True)
    return rows

if __name__ == "__main__":
    if sys.argv[1:] == ["--split-sweep"]:
        sys.exit(split_sweep_main())
    if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 4:
        sys.exit(kernel_times_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--predict-worker"] and len(sys.argv) == 3:
        sys.exit(predict_worker_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        sys.exit(ab_main(sys.argv[2]))
    if sys.argv[1:] == ["--vmap"]:
        sys.exit(vmap_main())
    if sys.argv[1:] == ["--example"]:
        sys.exit(example_main())
    if sys.argv[1:] == ["--parallel"]:
        sys.exit(parallel_main())
    if sys.argv[1:] == ["--vit"]:
        sys.exit(vit_main())
    if len(sys.argv) > 1:
        raise SystemExit(f"usage: {sys.argv[0]} [--ab PARENT_DIR | "
                         "--split-sweep | --vmap | --parallel | "
                         "--example | --vit]")
    sys.exit(main())
