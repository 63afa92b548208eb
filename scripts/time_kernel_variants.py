#!/usr/bin/env python3
"""Where the wgmma kernels' time goes, float32 and bf16, on one CUDA card.

    python3 scripts/time_kernel_variants.py   # -> chiprun_out/kernel_variants.json

Copies satae_torch/csrc into a temporary directory once per variant, removes
one part of a kernel by a text substitution (K1: the config walk of the
one-split grid, the epilogue's stores, the split-K cluster's reduction,
the wgmmas, float32's split pass, or the whole body; K2: the TMA loads of
one operand, the wgmmas, float32's split pass, the epilogue's stores),
builds every variant with nvcc in parallel (the package's own flags) and
times each at the main-path shapes in float32 and bf16, K1 also at the
vmap path's batched launches (C = 45), with chip_smoke.device_us.
A variant computes wrong numbers; its time, beside the unchanged kernel's,
is the cost of the part it removed. Every variant keeps the kernels'
mbarrier protocol (each full barrier still completes), so none can hang.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# float32: the three TF32 wgmmas of each k8 step, and the split pass (the
# A fragments stay unset, B's split tiles unwritten)
TF32_MMA = ("wgmma_tile.cuh",
            "    mma_k8<64>(d, as[j], big, j > 0);\n"
            "    mma_k8<64>(d, ab[j], small, 1);\n"
            "    mma_k8<64>(d, ab[j], big, 1);\n", "")
TF32_SPLIT = ("wgmma_tile.cuh",
              "  load_a_tf32<kTA>(ra, row0, ab, as);\n"
              "  split_b_tf32<kTB>(rb, bs, bs + kBox);\n", "")
# (variant, source file, old text, new text), applied in order
K1_VARIANTS = {
    "unchanged": [],
    "no persistence": [(
        "fused_gemm.cu",
        "    kernel<<<dim3(m_tiles, n_tiles, min(C, depth)), block, smem, "
        "stream>>>(",
        "    kernel<<<dim3(m_tiles, n_tiles, C), block, smem, stream>>>(")],
    "no epilogue stores": [(
        "fused_gemm.cu",
        "      store_rows<64>(cs, kLd, 64, out + c * mn, M, N, m0, n0, cols, "
        "act,", "      if (M < 0) store_rows<64>(cs, kLd, 64, out + c * mn, M, "
        "N, m0, n0, cols, act,")],
    "no cluster reduction": [
        ("fused_gemm.cu",
         "          q[t] = *cluster.map_shared_rank(\n"
         "              reinterpret_cast<float4*>(mine + tile * kPlane), "
         "block);",
         "          q[t] = *reinterpret_cast<float4*>(mine + tile * kPlane);"),
        ("fused_gemm.cu",
         "    store_cols<4>(out, static_cast<size_t>(m0 + row) * N + n0 + q4, "
         "v,\n                  quad_cols, nv, vec, act);", "")],
    "no wgmma": [(
        "wgmma_tile.cuh",
        "      issue_slice<kN, kTA, kTB>(d0, desc, s, 0);\n"
        "      issue_slice<kN, kTA, kTB>(d1, desc, s, 1);", ""), TF32_MMA],
    "no split": [TF32_SPLIT],
    "empty body": [(
        "fused_gemm.cu", "  constexpr int kLd = 64 + kOutPad;\n",
        "  constexpr int kLd = 64 + kOutPad;\n  if (M > 0) return;\n")],
}
K2_VARIANTS = {
    "unchanged": [],
    "no patch loads": [
        ("conv_bn_act.cu",
         "        bar_expect(&full[s], a_bytes + (kStage - kA));",
         "        bar_expect(&full[s], kStage - kA);"),
        ("conv_bn_act.cu",
         "        for (int h = 0; h < loads; ++h) {",
         "        for (int h = 0; h < 0; ++h) {")],
    "no weight loads": [
        ("conv_bn_act.cu",
         "        bar_expect(&full[s], a_bytes + (kStage - kA));",
         "        bar_expect(&full[s], a_bytes);"),
        ("conv_bn_act.cu",
         "          tma_load(st + kA, &map_w, &full[s], k0, n0);\n"
         "          tma_load(st + kA + kBox, &map_ws, &full[s], k0, n0);\n",
         ""),
        ("conv_bn_act.cu",
         "#pragma unroll\n"
         "          for (int b = 0; b < kBN / 64; ++b)\n"
         "            tma_load(st + kA + b * kBox, &map_w, &full[s], "
         "n0 + 64 * b, k0);\n", "")],
    "no wgmma": [
        ("wgmma_tile.cuh",
         "      issue_slice<kN, kTA, kTB>(d0, desc, s, 0);\n"
         "      issue_slice<kN, kTA, kTB>(d1, desc, s, 1);", ""),
        ("wgmma_tile.cuh",
         "      issue_slice<kN, kTA, kTB>(d0, desc, s, 0);\n"
         "      wgmma_commit();", "      wgmma_commit();"),
        ("wgmma_tile.cuh",
         "      issue_slice<kN, kTA, kTB>(d0, desc, s, 1);\n", ""), TF32_MMA,
        ("conv_bn_act.cu",
         "        mma_k8<32>(acc, small[j], db, j > 0);\n"
         "        mma_k8<32>(acc, big[j], ds, 1);\n"
         "        mma_k8<32>(acc, big[j], db, 1);\n", "")],
    "no split": [("wgmma_tile.cuh",
                  "    load_a_tf32<false>(ra, row0, ab, as);\n", "")],
    "no epilogue stores": [
        ("conv_bn_act.cu",
         "      store_rows<kBN>(cs, kLd, 128, out, M, Cout, m0, n0, cols, act,"
         "\n                      threadIdx.x, 2 * kWg);", ""),
        ("conv_bn_act.cu",
         "  store_rows<32>(cs, kLd, 128, out, m0 + 128, Cout, m0, 0, cols, "
         "act,\n                 threadIdx.x, kWg);", "")],
}
# (C, m, k, n, trans_a, trans_b): one-tile products, the batch-64 and
# serving long-K products (cluster split-K), the decoder input; then the
# vmap path's batched launches at C = 45: the projection forward and the
# decoder input's dX (2-split clusters), the decoder input forward and its
# dW (2,880 one-split tiles, the persistent grid), the head's fc1 forward
K1_SHAPES = ((1, 64, 64, 128, False, True), (1, 64, 4096, 64, False, True),
             (1, 512, 4096, 64, False, False), (1, 512, 64, 4096, False, True),
             (45, 64, 4096, 64, False, True), (45, 64, 4096, 64, False, False),
             (45, 64, 64, 4096, False, True), (45, 4096, 64, 64, True, False),
             (45, 64, 64, 128, False, True))
# (n, hw, cin, cout): conv0-3 of a 512-image chunk
K2_SHAPES = ((512, 64, 3, 32), (512, 32, 32, 64), (512, 16, 64, 128),
             (512, 8, 128, 256))


def build(root: Path, name: str, source: str, patches) -> tuple:
    from satae_torch.kernels import _build

    d = root / name.replace(" ", "_")
    shutil.copytree(_build.CSRC, d)
    for f, old, new in patches:
        text = (d / f).read_text()
        if old not in text:
            raise SystemExit(f"variant {name!r}: {f} has no {old[:60]!r}")
        (d / f).write_text(text.replace(old, new))
    so = d / f"lib{source}.so"
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
         str(d / f"{source}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, so


def bind(so: Path, source: str) -> ctypes.CDLL:
    from satae_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    for fn_name, (n_ptrs, n_ints) in _build.LAUNCHERS[source].items():
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
    lib.satae_error_string.restype = ctypes.c_char_p
    lib.satae_error_string.argtypes = [ctypes.c_int]
    return lib


def main() -> int:
    import torch

    from satae_torch.kernels import _build
    from satae_torch.kernels.conv import (conv_route, pack_conv_weight,
                                          split_tf32)
    from satae_torch.kernels.matmul import split_k_plan_tma

    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    card = chip_smoke.card_line()
    print(card, flush=True)
    root = Path(tempfile.mkdtemp(prefix="kernel_variants_"))
    t0 = time.perf_counter()
    jobs = {("fused_gemm", n): build(root, "k1_" + n, "fused_gemm", p)
            for n, p in K1_VARIANTS.items()}
    jobs.update({("conv_bn_act", n): build(root, "k2_" + n, "conv_bn_act", p)
                 for n, p in K2_VARIANTS.items()})
    libs = {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        chip_smoke.check(proc.returncode == 0, f"build of {key}:\n{log}")
        libs[key] = bind(so, key[0])
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for (c, m, k, n, ta, tb), dt in itertools.product(
            K1_SHAPES, (torch.float32, torch.bfloat16)):
        sfx = "" if dt == torch.float32 else "_bf16"
        a = torch.randn(c, *((k, m) if ta else (m, k)), device=dev,
                        generator=g).to(dt)
        b = torch.randn(c, *((n, k) if tb else (k, n)), device=dev,
                        generator=g).to(dt)
        scale = torch.rand(c, n, device=dev, generator=g) + 0.5
        shift = torch.rand(c, n, device=dev, generator=g) - 0.5
        out = torch.empty(c, m, n, device=dev, dtype=dt)
        _, _, splits, kps = split_k_plan_tma(m, n, k, batch=c, dtype=dt)
        for name in K1_VARIANTS:
            lib = libs[("fused_gemm", name)]
            run = lambda: _build.launch(
                lib, f"satae_fused_gemm_batched{sfx}_tma", dev, a.data_ptr(),
                b.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                out.data_ptr(), c, m, n, k, 0, int(ta), int(tb), splits, kps)
            us = chip_smoke.device_us(run, 0.0, f"K1 {name}", 50)
            rows.append(dict(kernel="fused_gemm" + sfx, batch=c,
                             shape=[m, k, n], trans=[ta, tb], splits=splits,
                             variant=name, device_us=us))
            print(f"K1{sfx:5s} C={c:2d} {str((m, k, n)):18s} "
                  f"{str((ta, tb)):14s} splits {splits:2d} {name:22s} "
                  f"{us:7.2f} us", flush=True)
    for (nimg, hw, cin, cout), dt in itertools.product(
            K2_SHAPES, (torch.float32, torch.bfloat16)):
        sfx = "" if dt == torch.float32 else "_bf16"
        x = torch.rand(nimg, hw, hw, cin, device=dev, generator=g).to(dt)
        w_oihw = torch.rand(cout, cin, 3, 3, device=dev, generator=g).to(dt)
        # the serving fold's layout: K-major in float32 (with its TF32
        # halves), HWIO in bf16
        w = pack_conv_weight(w_oihw)
        w_buf = w.permute(3, 0, 1, 2) if dt == torch.float32 else w
        scale = torch.ones(cout, device=dev)
        shift = torch.zeros(cout, device=dev)
        oh = hw // 2
        out = torch.empty(nimg, oh, oh, cout, device=dev, dtype=dt)
        route, tile_n = conv_route(x, w, 2, 1)
        halves = split_tf32(w) if dt == torch.float32 else None
        w_tf32 = (halves.data_ptr(),) if dt == torch.float32 else ()
        for name in K2_VARIANTS:
            lib = libs[("conv_bn_act", name)]
            run = lambda: _build.launch(
                lib, f"satae_conv2d_bn_act{sfx}_tma", dev, x.data_ptr(),
                w_buf.data_ptr(), *w_tf32, scale.data_ptr(),
                shift.data_ptr(), out.data_ptr(), nimg, hw, hw, cin, 3, 3,
                cout, oh, oh, 2, 1, 1, tile_n)
            us = chip_smoke.device_us(run, 0.0, f"K2 {name}", 20)
            rows.append(dict(kernel="conv2d_bn_act" + sfx,
                             shape=[nimg, hw, hw, cin, cout], route=route,
                             variant=name, device_us=us))
            print(f"K2{sfx:5s} {str((nimg, hw, cin, cout)):18s} "
                  f"{route:6s} {name:22s} {us:7.2f} us", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_variants.json").write_text(json.dumps(
        dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
