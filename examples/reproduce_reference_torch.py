"""Reproduce the reference notebook end to end with the satae_torch API, on an
NVIDIA GPU (or the CPU with ``--device cpu``).

The same flow, flags, artifacts and ``final.json`` as
examples/reproduce_reference.py, which runs it on the JAX package:

 1. ingest + class distribution + sample grid        (nb cells 5-10)
 2. seeded subsample + 70/15/15 split                (nb cells 8, 17)
 3. CE/MSE loss-scale calibration histogram          (nb cell 44)
 4. alpha x lr supervised-AE grid search + heatmap   (nb cells 52-54)
 5. best-AE loss curves                              (nb cell 56)
 6. frozen-encoder latent extraction                 (nb cell 60/66)
 7. MLP lr grid + accuracy curves                    (nb cells 63-66)
 8. confusion matrix + classification report         (nb cells 72-73)
 9. reconstruction grid + latent-space PCA scatter   (narrated at
    Report.md:3237-3259 but never drawn by the notebook)

Where matplotlib cannot be imported, each figure is skipped with one line
naming it, and every other stage runs.

Usage:
  python examples/reproduce_reference_torch.py --data /path/to/EuroSAT --out runs/repro
  (omit --data to run on the synthetic stand-in; add --quick for a small
   smoke-scale run; --device cpu runs the plain PyTorch path on the CPU,
   the default is the GPU and fails without one)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default="runs/repro")
    ap.add_argument("--quick", action="store_true",
                    help="small-scale smoke run (per_class=96, short grids)")
    ap.add_argument("--synthetic-difficulty", default="easy",
                    choices=("easy", "hard"),
                    help="synthetic tier when --data is absent ('hard' "
                         "lands in a realistic 60-90%% accuracy band)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    from satae_torch.api import SatAEPipeline
    from satae_torch.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                                    PipelineConfig)
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import iter_batches, make_splits
    from satae_torch.io.checkpoint import load_grid_results
    from satae_torch.train.calibrate import (CalibrationSummary,
                                             loss_ratio_calibration)
    from satae_torch.utils.logging import MetricsLogger
    from satae_torch.utils.profiling import Stopwatch
    try:
        from satae_torch.eval import plots
    except ImportError:
        plots = None

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    def figure(name: str, draw) -> None:
        if plots is None:
            print(f"matplotlib is not installed: {name} not written",
                  flush=True)
        else:
            draw(out / name)

    if args.quick:
        cfg = PipelineConfig(
            data=DataConfig(root=args.data, per_class=96,
                            synthetic_difficulty=args.synthetic_difficulty),
            ae=AETrainConfig(alphas=(20.0, 35.0),
                             learning_rates=(1e-3, 5e-3), max_epochs=15),
            mlp=MLPTrainConfig(learning_rates=(1e-3, 1e-2), epochs=12))
        n_inits = 50
    else:
        cfg = PipelineConfig(data=DataConfig(
            root=args.data,
            synthetic_difficulty=args.synthetic_difficulty))  # full scale
        n_inits = 1000
    log = MetricsLogger(out / "metrics.jsonl")
    sw = Stopwatch()

    # 1-2: ingest, subsample, split, data figures
    with sw.stage("ingest"):
        raw = load_dataset(cfg.data)
        splits = make_splits(raw, cfg.data)
    figure("class_distribution.png", lambda p: plots.class_distribution(
        raw.labels, raw.classes, p))
    figure("samples.png", lambda p: plots.sample_grid(
        raw.images, raw.labels, raw.classes, p))
    log(f"dataset: {len(raw)} images, splits "
        f"{len(splits.train)}/{len(splits.val)}/{len(splits.test)}")

    # 3: loss-scale calibration (reference uses latent_dim=128 here)
    with sw.stage("calibrate"):
        imgs, labels = next(iter_batches(splits.train, cfg.data.batch_size,
                                         shuffle=True, seed=0))
        ratios = loss_ratio_calibration(imgs, labels, n_inits=n_inits,
                                        device=args.device)
    figure("ratio_histogram.png", lambda p: plots.ratio_histogram(ratios, p))
    cal = CalibrationSummary.from_ratios(ratios)
    log(f"CE/MSE ratio at init: median={cal.median:.1f} "
        f"(reference: ~30-32, Report.md:534)")

    # 4-8: the full pipeline (AE grid -> latents -> MLP grid -> eval); fit
    # draws its own curves, or logs the ones it could not
    with sw.stage("fit"):
        pipe = SatAEPipeline(cfg, device=args.device)
        summary = pipe.fit(raw, grid=True, out_dir=str(out), log=log)

    results = load_grid_results(out / "validation_losses.json")
    figure("gridsearch_heatmap.png", lambda p: plots.gridsearch_heatmap(
        results, p))

    with sw.stage("evaluate"):
        result = pipe.evaluate(splits.test)
    figure("confusion_matrix.png", lambda p: plots.confusion_display(
        result["confusion_matrix"], splits.classes, p))
    # two figures the notebook narrates but never draws: originals vs x_hat,
    # and the latent space whose structure the report analyses
    recons = pipe.reconstruct_batched(splits.test.images[:8])
    latents = pipe.encode_batched(splits.test.images)
    figure("reconstruction_grid.png", lambda p: plots.reconstruction_grid(
        splits.test.images[:8], recons, p))
    figure("latent_space_test.png", lambda p: plots.latent_scatter(
        latents, splits.test.labels, splits.classes, p))
    print(result["report"])
    log({"test_accuracy": float(result["accuracy"]),
         "reference_headline": 0.7473, **sw.report()})
    (out / "final.json").write_text(json.dumps({
        "test_accuracy": float(result["accuracy"]),
        "ae": summary.ae_hparams, "mlp": summary.mlp_hparams,
        "calibration_median": cal.median, "timings_s": sw.report()}, indent=2))


if __name__ == "__main__":
    main()
