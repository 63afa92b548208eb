"""``fit --grid`` of the port's CLI on two ranks over Gloo on the CPU,
through ``torch.distributed.run``, against the same command in one process
(the full width at per class 12, one epoch each, so the default 45-config
AE grid and 11-lr MLP grid run in seconds)."""

import json
import os
import subprocess
import sys
from pathlib import Path


def test_cli_fit_grid_on_two_ranks(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m satae_torch.cli fit
    --grid --multihost --n-devices 2 --device cpu`` (the full width, per
    class 12, one epoch each) against the same fit in one process: both
    ranks print the summary the one-process fit prints, the stores and the
    checkpoints are its bytes (each config trains alone on its rank with its
    sequential seed), the metrics log is written once, by rank 0."""
    root = Path(__file__).resolve().parent.parent
    cache = tmp_path / "cache"
    args = ["fit", "--grid", "--per-class", "12", "--ae-epochs", "1",
            "--mlp-epochs", "1", "--device", "cpu", "--cache-dir", str(cache)]
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "2"}
    one = subprocess.run([sys.executable, "-m", "satae_torch.cli", *args,
                          "--out", str(tmp_path / "one")], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "satae_torch.cli", *args,
         "--multihost",
         "--n-devices", "2", "--out", str(tmp_path / "two")],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]

    def summaries(text):
        dec, out, i = json.JSONDecoder(), [], text.find("{\n")
        while i >= 0:
            obj, end = dec.raw_decode(text, i)
            out.append(obj)
            i = text.find("{\n", end)
        return out

    want = summaries(one.stdout)
    got = summaries(two.stdout)
    assert len(want) == 1 and len(got) == 2
    for s in got:
        s.pop("stage_seconds")
    want[0].pop("stage_seconds")
    assert got == want * 2
    run1, run2 = tmp_path / "one", tmp_path / "two"
    for name in ("validation_losses.json", "mlp_results.json",
                 "ae_global_best.msgpack", "ae_global_best.json",
                 "mlp_global_best.msgpack", "mlp_global_best.json",
                 "classes.json", "mlp_provenance.json"):
        assert (run2 / name).read_bytes() == (run1 / name).read_bytes(), name
    n_configs = len(json.loads((run1 / "validation_losses.json").read_text()))
    log = (run2 / "metrics.jsonl").read_text().splitlines()
    assert sum('"msg": "alpha=' in ln for ln in log) == n_configs
    assert len(log) == len((run1 / "metrics.jsonl").read_text().splitlines())
    assert not list(run2.glob("*.tmp.*"))
