"""Do the decoder's convolutions repeat bit for bit on the card, and what
do cuDNN's deterministic algorithms cost there?

The entry points that run convolutions outside ``fit`` -- ``decode``,
``reconstruct_batched`` and calibration's ``init_ratio`` -- enter
``satae_torch.nn.layers.float32_convs``. This script runs them with that
context forced to cuDNN's default algorithm choice and to its deterministic
set, in turn, on the committed models (benchmarks/full_run_hard_f32 and
_bf16) over the 2,990-image synthetic-hard test split (per_class 2000):

* ``reconstruct_batched`` and ``decode`` three times each on the same
  inputs, float32 and bf16: the largest |difference| of the repeats to the
  first call and the share of elements that differ; and decode(encode(x))
  against reconstruct(x);
* the sharded pipeline at world size 1 (``RuntimeConfig(n_devices=1)``, a
  group of one rank) against the plain one, ``decode`` and ``reconstruct``;
* ``init_ratio`` of 20 calibration inits (latent 128, chip_smoke phase
  18's batch augmented on the CPU), each twice;
* ``reconstruct_batched``'s ms per call (10 calls after a warm-up, CUDA
  events) in turns default, deterministic, deterministic, default.

Prints the card line first and writes chiprun_out/decode_repeats.json.

Usage (one CUDA card): python3 scripts/decode_repeats.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

MODES = ("default", "deterministic")
N_INITS = 20


@contextlib.contextmanager
def forced(mode: str):
    """``float32_convs`` at the entry points, with cuDNN's deterministic
    algorithms on (``deterministic``) or off (``default``) whatever the
    caller passes."""
    from satae_torch import api
    from satae_torch.nn import layers as L
    from satae_torch.train import calibrate

    def convs(deterministic: bool = False):
        return L.float32_convs(deterministic=mode == "deterministic")

    saved = api.float32_convs, calibrate.float32_convs
    api.float32_convs = calibrate.float32_convs = convs
    try:
        yield
    finally:
        api.float32_convs, calibrate.float32_convs = saved


def repeats(outs) -> dict:
    """The later calls against the first: largest |difference| and the
    share of elements that differ."""
    import numpy as np

    first = outs[0]
    return dict(max_abs=[float(np.abs(o - first).max()) for o in outs[1:]],
                differ_share=[float((o != first).mean()) for o in outs[1:]])


def main() -> int:
    import numpy as np
    import torch

    from satae_torch.api import SatAEPipeline
    from satae_torch.config import (DataConfig, ModelConfig, PipelineConfig,
                                    RuntimeConfig)
    from satae_torch.data.augment import augment_train_batch
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import iter_batches, make_splits
    from satae_torch.kernels import _build
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.nn.init import init_
    from satae_torch.train.calibrate import init_ratio

    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    card = chip_smoke.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cudnn "
          f"{torch.backends.cudnn.version()}", flush=True)
    _build.build_all()
    data = DataConfig(per_class=2000, synthetic_difficulty="hard")
    splits = make_splits(load_dataset(data), data)
    test = splits.test
    dev = torch.device("cuda")
    res = {"card": card, "n_images": len(test)}
    pipes = {}
    for mode in MODES:
        out = res[mode] = {}
        with forced(mode):
            for dtype, ckpt in (("float32", chip_smoke.CKPT),
                                ("bfloat16", chip_smoke.CKPT_BF16)):
                cfg = PipelineConfig(data=data, runtime=RuntimeConfig(
                    compute_dtype=dtype))
                pipe = pipes.setdefault(dtype, SatAEPipeline(cfg).load(
                    str(ckpt)))
                rec = [pipe.reconstruct_batched(test.images)
                       for _ in range(3)]
                z = pipe.encode(test.images)
                dec = [pipe.decode(z) for _ in range(3)]
                out[dtype] = dict(
                    reconstruct=repeats(rec), decode=repeats(dec),
                    decode_vs_reconstruct=float(np.abs(dec[0] - rec[0])
                                                .max()))
                print(f"{mode} {dtype}: reconstruct repeats "
                      f"{out[dtype]['reconstruct']}, decode repeats "
                      f"{out[dtype]['decode']}, decode(encode(x)) vs "
                      f"reconstruct(x) {out[dtype]['decode_vs_reconstruct']!r}",
                      flush=True)
            cfg = PipelineConfig(data=data)
            sharded = SatAEPipeline(dataclasses.replace(
                cfg, runtime=RuntimeConfig(n_devices=1))).load(
                    str(chip_smoke.CKPT))
            z = pipes["float32"].encode(test.images)
            pairs = {"decode": (sharded.decode(z), pipes["float32"].decode(z)),
                     "reconstruct": (sharded.reconstruct(test.images),
                                     pipes["float32"].reconstruct(
                                         test.images))}
            out["sharded_world_1"] = {
                k: dict(max_abs=float(np.abs(a - b).max()),
                        differ_share=float((a != b).mean()))
                for k, (a, b) in pairs.items()}
            print(f"{mode}: sharded (world size 1) vs plain "
                  f"{out['sharded_world_1']}", flush=True)
            imgs, labels = next(iter_batches(splits.train, data.batch_size,
                                             shuffle=True, seed=0))
            x = augment_train_batch(
                torch.from_numpy(imgs), crop_padding=data.crop_padding,
                noise_std=data.noise_std,
                generator=torch.Generator().manual_seed(0)).to(dev)
            y = torch.from_numpy(np.asarray(labels)).long().to(dev)
            model = SupervisedAE(ModelConfig(latent_dim=128), 3, 64).to(dev)
            pairs = []
            for i in range(N_INITS):
                init_(model, torch.Generator(device=dev).manual_seed(
                    (1 << 32) + i))
                pairs.append((float(init_ratio(model, x, y)),
                              float(init_ratio(model, x, y))))
            out["init_ratio"] = dict(
                n_inits=N_INITS, differ=sum(a != b for a, b in pairs),
                max_rel=max(abs(a - b) / abs(a) for a, b in pairs))
            print(f"{mode}: init_ratio repeats {out['init_ratio']}",
                  flush=True)
    timing = res["reconstruct_ms"] = {}
    for dtype, pipe in pipes.items():
        ms = {m: [] for m in MODES}
        for mode in ("default", "deterministic", "deterministic",
                     "default"):
            with forced(mode):
                pipe.reconstruct_batched(test.images)  # warm-up
                ms[mode].append(chip_smoke.time_ms(
                    lambda: pipe.reconstruct_batched(test.images), reps=10,
                    warmup=1))
        timing[dtype] = {m: dict(ms=v, images_per_s=[len(test) / (t / 1e3)
                                                     for t in v])
                         for m, v in ms.items()}
        print(f"reconstruct_batched {dtype} ms per call in turns: "
              + ", ".join(f"{m} {[round(t, 3) for t in v]} "
                          f"({[round(len(test) / (t / 1e3), 1) for t in v]}"
                          " images/s)" for m, v in ms.items())
              + f"; card {card}", flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "decode_repeats.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"decode_repeats: {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)
