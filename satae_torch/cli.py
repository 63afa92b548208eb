"""Command-line interface of the port: satae/cli.py's subcommands, flags,
artifacts and standard output, on PyTorch.

  python -m satae_torch.cli fit          — the pipeline (AE [grid] -> latents
                                           -> MLP [grid] -> test evaluation
                                           + artifacts)
  python -m satae_torch.cli calibrate    — CE/MSE loss-scale experiment
  python -m satae_torch.cli evaluate     — load a run dir, evaluate a split
  python -m satae_torch.cli extract      — frozen-encoder latents per split
  python -m satae_torch.cli predict      — classify image files to CSV
  python -m satae_torch.cli reconstruct  — autoencoder reconstructions
  python -m satae_torch.cli export-torch — the reference's .pt state_dicts
  python -m satae_torch.cli report       — figures from saved artifacts

One flag is added, ``--device`` (default ``cuda``): every entry point runs on
that device, and ``--device cpu`` runs the kernels' plain versions on the
CPU. ``--parallel`` runs the grid's config-batched (vmap) sweeps
(satae_torch.train.vmap_sweep). satae's multi-device flags run one process
per device (satae_torch.parallel): ``--multihost`` joins the process group
``torchrun`` describes before any device is touched (NCCL on ``cuda``,
Gloo on ``cpu``), ``--n-devices N`` trains, sweeps and serves over its N
ranks, and ``--grid-dp`` gives each grid config that many of them:

  torchrun --nproc-per-node N -m satae_torch.cli fit --multihost --n-devices N

Every rank runs the command and prints its output; the files of a run
directory are written by every rank with the same bytes, figures, reports
and the metrics log by rank 0 only. ``--pallas`` is accepted and changes
nothing: the port always serves through its kernels.
The figures need matplotlib, which is imported only where one is drawn: a
subcommand that draws raises ``ImportError`` without it, except for the
figures satae draws unasked: ``fit`` without ``--grid`` logs the two curve
figures it could not write, and ``calibrate`` notes on stderr the
histogram it could not write; both complete.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from satae_torch.parallel.distributed import is_primary, maybe_initialize
from satae_torch.utils.strict_json import dump_strict_json


def _config_from_args(args) -> "PipelineConfig":
    from satae_torch.config import (AETrainConfig, DataConfig,
                                    MLPTrainConfig, PipelineConfig,
                                    RuntimeConfig)

    ae = AETrainConfig()
    if args.ae_epochs is not None:
        ae = dataclasses.replace(ae, max_epochs=args.ae_epochs)
    if getattr(args, "ckpt_every", 0):
        ae = dataclasses.replace(ae, checkpoint_every=args.ckpt_every)
    mlp = MLPTrainConfig() if args.mlp_epochs is None else \
        MLPTrainConfig(epochs=args.mlp_epochs)
    cfg = PipelineConfig(
        data=DataConfig(root=args.data, per_class=args.per_class,
                        cache_dir=args.cache_dir,
                        synthetic_difficulty=getattr(
                            args, "synthetic_difficulty", "easy"),
                        aug_rng_impl=getattr(args, "aug_rng", "threefry")),
        ae=ae,
        mlp=mlp,
        runtime=RuntimeConfig(seed=args.seed,
                              parallel_configs=args.parallel,
                              compute_dtype=args.dtype,
                              n_devices=args.n_devices,
                              multihost=getattr(args, "multihost", False),
                              grid_dp=getattr(args, "grid_dp", 1),
                              debug_nans=args.debug_nans,
                              save_grid_curves=getattr(args, "save_curves",
                                                       False)),
    )
    if getattr(args, "throughput", False):
        from satae_torch.config import throughput_config
        cfg = throughput_config(cfg)
    return cfg


def cmd_fit(args) -> None:
    from satae_torch.api import SatAEPipeline
    from satae_torch.utils.logging import MetricsLogger

    cfg = _config_from_args(args)
    pipe = SatAEPipeline(cfg, device=args.device)
    primary = is_primary()
    if args.ae_torch:
        # notebook-user migration: start from a reference AE_GLOBAL_BEST.pt
        pipe.load_torch(args.ae_torch)
    elif args.reuse_ae:
        pipe.load_ae(args.out)
    log = MetricsLogger(Path(args.out) / "metrics.jsonl" if primary else None,
                        echo=primary)
    summary = pipe.fit(grid=args.grid, out_dir=args.out, log=log,
                       reuse_ae=args.reuse_ae or bool(args.ae_torch))
    print(dump_strict_json(dataclasses.asdict(summary), indent=2))

    results_file = Path(args.out) / "validation_losses.json"
    if results_file.exists() and primary:
        from satae_torch.eval import plots
        from satae_torch.io.checkpoint import load_grid_results
        plots.gridsearch_heatmap(load_grid_results(results_file),
                                 Path(args.out) / "gridsearch_heatmap.png")


def cmd_calibrate(args) -> None:
    from satae_torch.config import DataConfig
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import iter_batches, make_splits
    from satae_torch.train.calibrate import (CalibrationSummary,
                                             loss_ratio_calibration)

    data_cfg = DataConfig(root=args.data, per_class=args.per_class,
                          cache_dir=args.cache_dir,
                          synthetic_difficulty=getattr(
                              args, "synthetic_difficulty", "easy"),
                          aug_rng_impl=getattr(args, "aug_rng", "threefry"))
    raw = load_dataset(data_cfg)
    splits = make_splits(raw, data_cfg)
    imgs, labels = next(iter_batches(splits.train, data_cfg.batch_size,
                                     shuffle=True, seed=args.seed))
    ratios = loss_ratio_calibration(imgs, labels, data_cfg=data_cfg,
                                    n_inits=args.n_inits,
                                    seed=args.seed, device=args.device)
    summary = CalibrationSummary.from_ratios(ratios)
    print(dump_strict_json(dataclasses.asdict(summary), indent=2))
    if args.out and is_primary():
        Path(args.out).mkdir(parents=True, exist_ok=True)
        try:
            from satae_torch.eval import plots
        except ImportError:
            # satae draws the histogram whenever --out is set, and --out
            # has a default: without matplotlib the summary is written all
            # the same, with a note on stderr (stdout stays the JSON)
            print("matplotlib is not installed: ratio_histogram.png not "
                  "written", file=sys.stderr)
        else:
            plots.ratio_histogram(ratios,
                                  Path(args.out) / "ratio_histogram.png")
        (Path(args.out) / "calibration.json").write_text(
            dump_strict_json(dataclasses.asdict(summary), indent=2))


def cmd_evaluate(args) -> None:
    from satae_torch.api import SatAEPipeline
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits

    cfg = _config_from_args(args)
    pipe = SatAEPipeline(cfg, device=args.device).load(args.out)
    raw = load_dataset(cfg.data)
    splits = make_splits(raw, cfg.data)
    pipe.classes = pipe.classes or splits.classes
    ds = getattr(splits, args.split)
    result = pipe.evaluate(ds)
    print(result["report"])
    print(f"\naccuracy: {result['accuracy']:.4f}")
    if not is_primary():
        return
    from satae_torch.eval import plots
    plots.confusion_display(result["confusion_matrix"],
                            pipe.classes or [str(i) for i in range(10)],
                            Path(args.out) / f"confusion_{args.split}.png")
    # the per-class table beside the PNG (the pair of artifacts the
    # reference's final cells produce)
    (Path(args.out) / f"classification_report_{args.split}.txt").write_text(
        result["report"])


def cmd_extract(args) -> None:
    """Frozen-encoder latent extraction to .npz (reference C19/C20: the
    latent datasets)."""
    import numpy as np

    from satae_torch.api import SatAEPipeline
    from satae_torch.data.ingest import load_dataset
    from satae_torch.data.pipeline import make_splits
    from satae_torch.train.extract import extract_features

    cfg = _config_from_args(args)
    pipe = SatAEPipeline(cfg, device=args.device).load(args.out)
    raw = load_dataset(cfg.data)
    splits = make_splits(raw, cfg.data)
    out = Path(args.out)
    for split in ("train", "val", "test"):
        X, y = extract_features(pipe.ae.enc, getattr(splits, split),
                                cfg.data.batch_size, cfg.compute_dtype,
                                pipe._mesh())
        if not is_primary():
            continue
        np.savez(out / f"latents_{split}.npz", X=X, y=y)
        print(f"wrote {out / f'latents_{split}.npz'}  X={X.shape}")
        if args.plot:
            from satae_torch.eval import plots
            classes = pipe.classes or [str(i) for i in
                                       range(cfg.model.num_classes)]
            p = plots.latent_scatter(X, y, classes,
                                     out / f"latent_space_{split}.png")
            print(f"wrote {p}")


def cmd_predict(args) -> None:
    """Batch serving: classify every image under --images (flat dir, class
    tree, or a single file) with the checkpoints in --out; writes a CSV of
    path,class_id,class_name. The inference counterpart of `evaluate` for
    unlabeled data."""
    import csv

    from satae_torch.api import SatAEPipeline
    from satae_torch.data.ingest import (decode_images, resolve_image_root,
                                         scan_images)

    cfg = _config_from_args(args)
    pipe = SatAEPipeline(cfg, device=args.device).load(args.out)
    root = resolve_image_root(args.images, cfg.data.cache_dir,
                              cfg.data.image_size)
    paths = scan_images(root)
    if not paths:
        raise FileNotFoundError(f"no images under {args.images}")
    images = decode_images(paths, cfg.data.image_size)
    probs = pipe.predict_proba_batched(images)
    preds = probs.argmax(axis=-1)
    conf = probs.max(axis=-1)
    classes = pipe.classes or tuple(
        str(i) for i in range(cfg.model.num_classes))
    dest = Path(args.csv) if args.csv else Path(args.out) / "predictions.csv"
    if not is_primary():
        return
    with open(dest, "w", newline="") as f:
        w = csv.writer(f)
        hdr = ["path", "class_id", "class_name", "confidence"]
        if args.proba:
            # column names track the PROBABILITY width, not len(classes):
            # a run fitted on a class subset must still emit a rectangular
            # CSV (extra heads fall back to numeric column names)
            hdr += [f"p_{classes[j]}" if j < len(classes) else f"p_{j}"
                    for j in range(probs.shape[1])]
        w.writerow(hdr)
        for i, (p, c, pr) in enumerate(zip(paths, preds, conf)):
            name = classes[int(c)] if int(c) < len(classes) else str(int(c))
            row = [str(p), int(c), name, f"{pr:.4f}"]
            if args.proba:
                row += [f"{q:.4f}" for q in probs[i]]
            w.writerow(row)
    print(f"wrote {dest} ({len(paths)} predictions)")


def cmd_reconstruct(args) -> None:
    """Autoencoder serving: reconstruct every image under --images through
    the fitted encoder+decoder, write per-image reconstruction PNGs, a
    side-by-side grid figure, and a CSV of per-image reconstruction MSE
    (usable as an anomaly/novelty score — images unlike the training
    distribution reconstruct poorly)."""
    import csv

    import numpy as np

    from satae_torch.api import SatAEPipeline
    from satae_torch.data.ingest import (decode_images, resolve_image_root,
                                         scan_images)
    from satae_torch.eval import plots

    cfg = _config_from_args(args)
    pipe = SatAEPipeline(cfg, device=args.device).load(args.out)
    root_str = resolve_image_root(args.images, cfg.data.cache_dir,
                                  cfg.data.image_size)
    paths = scan_images(root_str)
    if not paths:
        raise FileNotFoundError(f"no images under {args.images}")
    images = decode_images(paths, cfg.data.image_size)
    recons = pipe.reconstruct_batched(images)
    mse = np.mean(
        np.square(recons - images.astype(np.float32) / 255.0),
        axis=(1, 2, 3))
    if not is_primary():
        return

    dest = Path(args.dest) if args.dest else Path(args.out) / "reconstructions"
    dest.mkdir(parents=True, exist_ok=True)
    from PIL import Image
    u8 = np.rint(np.clip(recons, 0.0, 1.0) * 255.0).astype(np.uint8)
    root = Path(root_str)
    seen = set()
    targets = []
    for p, rec in zip(paths, u8):
        # mirror the source layout relative to --images under dest, so
        # class trees (ClassA/img1.jpg, ClassB/img1.jpg) can never clobber
        # each other's reconstructions (flattening with separators is not
        # injective: A_B/c and A/B_c would collide). Same-stem siblings
        # with different extensions (img.jpg + img.png) keep the extension
        # in the name instead of overwriting.
        rel = Path(Path(p).relative_to(root) if root.is_dir()
                   else Path(p).name)
        target = dest / rel.parent / f"{rel.stem}_recon.png"
        if target in seen:
            target = dest / rel.parent / f"{rel.name}_recon.png"
        seen.add(target)
        targets.append(target)
        target.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rec).save(target)
    plots.reconstruction_grid(images, recons, dest / "reconstruction_grid.png")
    with open(dest / "reconstruction_mse.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("path", "recon_path", "mse"))
        for p, t, e in zip(paths, targets, mse):
            w.writerow((str(p), str(t), f"{e:.6f}"))
    print(f"wrote {len(paths)} reconstructions under {dest} "
          f"(mean MSE {float(mse.mean()):.6f})")


def cmd_export_torch(args) -> None:
    """Export the fitted checkpoints as the reference notebook's .pt files
    (AE_GLOBAL_BEST.pt / MLP_GLOBAL_BEST.pt)."""
    from satae_torch.api import SatAEPipeline

    cfg = _config_from_args(args)
    pipe = SatAEPipeline(cfg, device=args.device).load(args.out)
    dest = args.dest or args.out
    if not is_primary():
        return
    pipe.export_torch(dest)
    print(f"wrote {Path(dest) / 'AE_GLOBAL_BEST.pt'}")
    print(f"wrote {Path(dest) / 'MLP_GLOBAL_BEST.pt'}")


def cmd_report(args) -> None:
    """Re-render every figure derivable from a run dir's saved artifacts
    (no model evaluation): the grid heatmap from validation_losses.json and
    latent-space PCA scatters from any latents_{split}.npz `extract` left."""
    import json

    import numpy as np

    from satae_torch.eval import plots

    out = Path(args.out)
    if not is_primary():
        return
    results_file = out / "validation_losses.json"
    if results_file.exists():
        from satae_torch.io.checkpoint import load_grid_results
        p = plots.gridsearch_heatmap(load_grid_results(results_file),
                                     out / "gridsearch_heatmap.png")
        print(f"wrote {p}")
    classes_file = out / "classes.json"
    classes = (json.loads(classes_file.read_text())
               if classes_file.exists() else None)
    for split in ("train", "val", "test"):
        npz = out / f"latents_{split}.npz"
        if npz.exists():
            d = np.load(npz)
            cl = classes or [str(i) for i in
                             range(int(d["y"].max()) + 1 if len(d["y"])
                                   else 1)]
            p = plots.latent_scatter(d["X"], d["y"], cl,
                                     out / f"latent_space_{split}.png")
            print(f"wrote {p}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="satae_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--data", default=None, help="EuroSAT root directory or .zip archive")
        p.add_argument("--cache-dir", default=".satae_cache")
        p.add_argument("--per-class", type=int, default=2000)
        p.add_argument("--synthetic-difficulty", default="easy",
                       choices=("easy", "hard"),
                       help="synthetic stand-in tier when --data is absent: "
                            "'hard' targets a 60-90%% accuracy band so grid "
                            "selection discriminates")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--out", default="runs/default")
        p.add_argument("--parallel", action="store_true",
                       help="vmapped grid sweeps (all configs at once)")
        p.add_argument("--dtype", default="float32",
                       choices=("float32", "bfloat16"),
                       help="compute dtype (params stay float32)")
        p.add_argument("--pallas", action="store_true",
                       help="accepted for satae's command lines; the port "
                            "always serves through its kernels (K1/K2 on "
                            "the card)")
        p.add_argument("--n-devices", type=int, default=None,
                       help="device count, one rank each: data-parallel "
                            "training (grid=False) or config-parallel sweeps "
                            "(grid=True, one config per device per round); "
                            "the process group must have that many ranks")
        p.add_argument("--multihost", action="store_true",
                       help="join the process group torchrun describes "
                            "(init_method env://) before touching devices; "
                            "equivalent to SATAE_MULTIHOST=1")
        p.add_argument("--grid-dp", type=int, default=1,
                       help="grid mode: data-parallel devices per config "
                            "(2-D config x data mesh; n-devices must be "
                            "divisible by this)")
        p.add_argument("--ae-epochs", type=int, default=None,
                       help="override AE max_epochs (default 80)")
        p.add_argument("--ckpt-every", type=int, default=0,
                       help="flush in-flight AE train state every N epochs "
                            "under OUT/inflight/ (mid-training crash resume; "
                            "0 = off; checkpointed epochs run synchronously)")
        p.add_argument("--mlp-epochs", type=int, default=None,
                       help="override MLP epochs (default 30)")
        p.add_argument("--debug-nans", action="store_true",
                       help="raise at the first non-finite loss or gradient "
                            "of a train step (one host sync per step)")
        p.add_argument("--aug-rng", default="threefry",
                       choices=("threefry", "rbg"),
                       help="accepted for satae's command lines: the port "
                            "draws augmentation from one torch stream")
        p.add_argument("--device", default="cuda",
                       help="torch device of every entry point ('cpu' runs "
                            "the kernels' plain versions)")

    p_fit = sub.add_parser("fit", help="run the full pipeline")
    common(p_fit)
    p_fit.add_argument("--grid", action="store_true",
                       help="full 45-config AE grid + 11-lr MLP grid")
    p_fit.add_argument("--throughput", action="store_true",
                       help="opt-in large-batch recipe: batch 1024 + Adam "
                            "sqrt-scaled grid lrs; selection semantics "
                            "unchanged (see config.throughput_config)")
    p_fit.add_argument("--save-curves", action="store_true",
                       help="save per-config curve PNGs under OUT/curves/ "
                            "(the reference's per-LR figures)")
    p_fit.add_argument("--reuse-ae", action="store_true",
                       help="skip AE training: reuse OUT's existing "
                            "ae_global_best.msgpack and run extraction + "
                            "MLP training only (the notebook's phase-2 "
                            "restart)")
    p_fit.add_argument("--ae-torch", default=None, metavar="PT",
                       help="like --reuse-ae but start from a reference "
                            "AE_GLOBAL_BEST.pt torch checkpoint")
    p_fit.set_defaults(fn=cmd_fit)

    p_cal = sub.add_parser("calibrate", help="CE/MSE loss-scale experiment")
    common(p_cal)
    p_cal.add_argument("--n-inits", type=int, default=1000)
    p_cal.set_defaults(fn=cmd_calibrate)

    p_eval = sub.add_parser("evaluate", help="evaluate saved checkpoints")
    common(p_eval)
    p_eval.add_argument("--split", choices=("train", "val", "test"),
                        default="test")
    p_eval.set_defaults(fn=cmd_evaluate)

    p_ext = sub.add_parser("extract",
                           help="dump frozen-encoder latents per split")
    common(p_ext)
    p_ext.add_argument("--plot", action="store_true",
                       help="also save a latent-space PCA scatter per split")
    p_ext.set_defaults(fn=cmd_extract)

    p_pred = sub.add_parser("predict",
                            help="classify a directory (or file) of images "
                                 "to CSV using saved checkpoints")
    common(p_pred)
    p_pred.add_argument("--images", required=True,
                        help="image file, flat dir, class tree, or .zip archive")
    p_pred.add_argument("--csv", default=None,
                        help="destination CSV (default: OUT/predictions.csv)")
    p_pred.add_argument("--proba", action="store_true",
                        help="add one per-class probability column per class")
    p_pred.set_defaults(fn=cmd_predict)

    p_rec = sub.add_parser("reconstruct",
                           help="reconstruct images through the fitted "
                                "autoencoder (PNGs + grid figure + per-image "
                                "reconstruction-MSE CSV)")
    common(p_rec)
    p_rec.add_argument("--images", required=True,
                       help="image file, flat dir, class tree, or .zip archive")
    p_rec.add_argument("--dest", default=None,
                       help="destination dir (default: OUT/reconstructions)")
    p_rec.set_defaults(fn=cmd_reconstruct)

    p_exp = sub.add_parser("export-torch",
                           help="export checkpoints as reference-format .pt "
                                "state_dicts (strict-loadable by the "
                                "notebook's torch classes)")
    common(p_exp)
    p_exp.add_argument("--dest", default=None,
                       help="destination dir (default: OUT)")
    p_exp.set_defaults(fn=cmd_export_torch)

    p_rep = sub.add_parser("report", help="regenerate figures from artifacts")
    common(p_rep)
    p_rep.set_defaults(fn=cmd_report)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # the process group must exist before the first device is touched
    maybe_initialize(args.multihost, args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
