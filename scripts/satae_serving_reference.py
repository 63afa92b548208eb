"""satae's reconstruction MSE and loss-scale calibration on the CPU: the
references that chip_smoke.py's phases 17 (decoder serving) and 18
(calibration) are held against.

* Reconstruction: the committed full-width models
  `benchmarks/full_run_hard_f32` (float32) and `full_run_hard_bf16`
  (bfloat16) reconstruct the 2,990-image synthetic-hard test split
  (per_class 2000) through `satae.api.SatAEPipeline.reconstruct_batched`;
  the mean over images of each image's MSE against its uint8/255 input is
  recorded, and beside it the port's on the CPU (`satae_torch`, the plain
  kernel versions) and the largest |x_hat| difference of the two.
* Calibration: `satae.train.calibrate.loss_ratio_calibration` at satae's
  CLI defaults (latent 128, 1,000 inits, seed 0) on the batch
  `satae calibrate` takes: the first of `iter_batches(train split, 64,
  shuffle=True, seed=0)` of synthetic-hard per_class 2000. The median, p5
  and p95 are recorded with their bootstrap standard errors (2,000
  resamples of the 1,000 ratios); beside them the port's own calibration
  of the same batch on the CPU for augmentation seeds 0-4 (its draws are
  torch's, so the spread across seeds is the share of one augmented
  batch in the summary).

Writes `scripts/satae_serving_reference.json`.

Usage: JAX_PLATFORMS=cpu python scripts/satae_serving_reference.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "scripts" / "satae_serving_reference.json"
QUANTILES = {"median": 50.0, "p5": 5.0, "p95": 95.0}


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from satae.api import SatAEPipeline
    from satae.config import DataConfig, PipelineConfig, RuntimeConfig
    from satae.data.ingest import load_dataset
    from satae.data.pipeline import iter_batches, make_splits
    from satae.train.calibrate import loss_ratio_calibration
    import satae_torch.config as TC
    from satae_torch.api import SatAEPipeline as PortPipeline
    from satae_torch.train.calibrate import loss_ratio_calibration as port_cal

    data = DataConfig(per_class=2000, synthetic_difficulty="hard")
    t0 = time.perf_counter()
    splits = make_splits(load_dataset(data), data)
    test = splits.test
    x = test.images.astype(np.float32) / 255.0
    out = {"data_s": time.perf_counter() - t0, "n_test": len(test)}
    for dtype, ckpt in (("float32", "full_run_hard_f32"),
                        ("bfloat16", "full_run_hard_bf16")):
        t0 = time.perf_counter()
        theirs = SatAEPipeline(PipelineConfig(
            data=data, runtime=RuntimeConfig(compute_dtype=dtype))).load(
            str(REPO / "benchmarks" / ckpt)).reconstruct_batched(test.images)
        ours = PortPipeline(TC.PipelineConfig(runtime=TC.RuntimeConfig(
            compute_dtype=dtype)), device="cpu").load(
            str(REPO / "benchmarks" / ckpt)).reconstruct_batched(test.images)
        mse = lambda r: float(np.mean(np.mean(np.square(r - x),
                                              axis=(1, 2, 3))))
        out[f"reconstruct_{dtype}"] = dict(
            checkpoint=f"benchmarks/{ckpt}", satae_mean_mse=mse(theirs),
            port_cpu_mean_mse=mse(ours),
            port_cpu_max_abs_diff=float(np.abs(ours - theirs).max()),
            seconds=time.perf_counter() - t0)
        print(dtype, out[f"reconstruct_{dtype}"], flush=True)

    imgs, labels = next(iter_batches(splits.train, data.batch_size,
                                     shuffle=True, seed=0))
    t0 = time.perf_counter()
    ratios = loss_ratio_calibration(imgs, labels, data_cfg=data,
                                    n_inits=1000, seed=0)
    cal_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    boot = rng.choice(ratios, size=(2000, len(ratios)), replace=True)
    summary = {k: float(np.percentile(ratios, q))
               for k, q in QUANTILES.items()}
    se = {k: float(np.std(np.percentile(boot, q, axis=1), ddof=1))
          for k, q in QUANTILES.items()}
    port = {}
    for seed in range(5):
        r = port_cal(imgs, labels, data_cfg=TC.DataConfig(), n_inits=1000,
                     seed=seed, device="cpu")
        port[seed] = {k: float(np.percentile(r, q))
                      for k, q in QUANTILES.items()}
        print("port seed", seed, port[seed], flush=True)
    out["calibration"] = dict(
        n_inits=1000, latent_dim=128, seed=0, batch=int(len(imgs)),
        satae=summary, satae_mean=float(np.mean(ratios)),
        bootstrap_se=se, satae_seconds=cal_s,
        port_cpu_by_seed={str(k): v for k, v in port.items()},
        ratios=[float(v) for v in ratios])
    print("satae", summary, "se", se, flush=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
