"""satae's own grid fit on the pc256 cross-framework gate, in a chosen
compute dtype, on the CPU: the reference that chip_smoke.py's bf16 grid
phase is held against.

The gate (`benchmarks/torch_parity_pc256/torch_pipeline_parity.json`)
records satae's float32 result only. This runs the same configuration
(per_class 256 synthetic-hard, AE alpha x lr grid of 15 epochs, 3 MLP lrs
of 30 epochs, seed 0) through `satae.api.SatAEPipeline.fit(grid=True)` with
`RuntimeConfig(compute_dtype=...)`, and writes the summary and every
config's stored result to `scripts/satae_pc256_gate_<dtype>.json`.

Usage: JAX_PLATFORMS=cpu python scripts/satae_gate_reference.py
           [--dtype bfloat16|float32]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    from satae.api import SatAEPipeline
    from satae.config import (AETrainConfig, DataConfig, MLPTrainConfig,
                              PipelineConfig, RuntimeConfig)
    from satae.data.ingest import load_dataset

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
        runtime=RuntimeConfig(seed=gate["seed"], compute_dtype=args.dtype))
    raw = load_dataset(cfg.data)
    log = lambda s: print(s, flush=True)
    with tempfile.TemporaryDirectory() as run:
        t0 = time.perf_counter()
        summary = SatAEPipeline(cfg).fit(raw, grid=True, out_dir=run,
                                         log=log)
        seconds = time.perf_counter() - t0
        stores = {name: json.loads((Path(run) / name).read_text())
                  for name in ("validation_losses.json", "mlp_results.json")}
    result = {
        "dtype": args.dtype, "platform": jax.devices()[0].platform,
        "jax": jax.__version__,
        "config": {k: gate[k] for k in ("per_class", "ae_epochs", "ae_grid",
                                        "mlp_lrs", "mlp_epochs", "seed")},
        "satae": {"ae_best_val_loss": summary.ae_val_loss,
                  "ae_hparams": summary.ae_hparams,
                  "mlp_best_val_acc": summary.mlp_val_acc,
                  "mlp_hparams": summary.mlp_hparams,
                  "test_acc": summary.test_acc},
        "stores": stores, "seconds": seconds,
    }
    out = REPO / "scripts" / f"satae_pc256_gate_{args.dtype}.json"
    out.write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps(result["satae"]), flush=True)


if __name__ == "__main__":
    main()
