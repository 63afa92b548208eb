"""examples/reproduce_reference_torch.py, the notebook's flow on satae_torch,
held against examples/reproduce_reference.py, the same flow on satae.

  * tier 1: both examples' ``main()`` on the CPU with their configs swapped
    for a tiny model (latent 8, channels (4, 8), 16x16 images, 1 + 1
    epochs, 4 calibration inits) by the same patch of each package's
    ``PipelineConfig`` and ``loss_ratio_calibration``: the same artifacts,
    the same ``final.json`` keys and stages, the same ``metrics.jsonl``
    lines (keys and messages, up to the numbers in them); then the port's
    with matplotlib patched away: each figure skipped with one line naming
    it, everything else written;
  * slow: the port's ``--quick --synthetic-difficulty hard`` on the CPU
    against satae's own run of its example, recorded by
    scripts/satae_example_reference.py in
    scripts/satae_example_quick_hard.json: test accuracy within
    chip_smoke.py phase 29's 0.05.
"""

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest

from torch_port_threads import two_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "scripts" / "satae_example_quick_hard.json"
BAND = 0.05  # chip_smoke.py phase 29
FIGURES = ("class_distribution.png", "samples.png", "ratio_histogram.png",
           "gridsearch_heatmap.png", "confusion_matrix.png",
           "reconstruction_grid.png", "latent_space_test.png")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny(monkeypatch, config, calibrate) -> None:
    """The example's configs, cut to a tiny model, in one package."""
    model = config.ModelConfig(latent_dim=8, encoder_channels=(4, 8),
                               head_hidden=16, mlp_hidden=(16, 8))
    make, cal = config.PipelineConfig, calibrate.loss_ratio_calibration

    def pipeline(data, ae, mlp):
        return make(data=dataclasses.replace(data, per_class=8,
                                             image_size=16, batch_size=8),
                    model=model, ae=dataclasses.replace(ae, max_epochs=1),
                    mlp=dataclasses.replace(mlp, epochs=1))

    def calibration(imgs, labels, *, n_inits, **kw):
        return cal(imgs, labels, n_inits=4, model_cfg=model, **kw)

    monkeypatch.setattr(config, "PipelineConfig", pipeline)
    monkeypatch.setattr(calibrate, "loss_ratio_calibration", calibration)


def _port(monkeypatch, out: Path) -> None:
    from satae_torch import config
    from satae_torch.train import calibrate
    _tiny(monkeypatch, config, calibrate)
    _example("reproduce_reference_torch").main(
        ["--quick", "--synthetic-difficulty", "hard", "--out", str(out),
         "--device", "cpu"])


def _lines(out: Path) -> list:
    """metrics.jsonl without its times, numbers masked in its messages."""
    lines = []
    for ln in (out / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(ln)
        rec.pop("t")
        lines.append(re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", rec["msg"])
                     if "msg" in rec else sorted(rec))
    return lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        from satae import config as JC
        from satae.train import calibrate as jcal
        _tiny(mp, JC, jcal)
        jout = tmp_path_factory.mktemp("satae_example")
        mp.setattr(sys, "argv", ["reproduce_reference.py", "--quick",
                                 "--synthetic-difficulty", "hard", "--out",
                                 str(jout)])
        _example("reproduce_reference").main()
        tout = tmp_path_factory.mktemp("port_example")
        _port(mp, tout)
    finally:
        mp.undo()
    return jout, tout


def test_example_writes_satae_examples_artifacts(runs):
    jout, tout = runs
    names = sorted(p.name for p in jout.iterdir())
    assert sorted(p.name for p in tout.iterdir()) == names
    assert set(FIGURES) <= set(names)
    jfin, tfin = (json.loads((d / "final.json").read_text()) for d in runs)
    assert list(tfin) == list(jfin) == ["test_accuracy", "ae", "mlp",
                                        "calibration_median", "timings_s"]
    assert list(tfin["timings_s"]) == list(jfin["timings_s"]) == [
        "ingest", "calibrate", "fit", "evaluate"]
    assert set(tfin["ae"]) == set(jfin["ae"]) == {"alpha", "lr"}
    assert set(tfin["mlp"]) == set(jfin["mlp"]) == {"lr"}
    assert 0.0 <= tfin["test_accuracy"] <= 1.0
    assert _lines(tout) == _lines(jout)


def test_example_without_matplotlib(monkeypatch, tmp_path, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    import satae_torch.eval
    monkeypatch.delitem(sys.modules, "satae_torch.eval.plots", raising=False)
    monkeypatch.delattr(satae_torch.eval, "plots", raising=False)
    _port(monkeypatch, tmp_path)
    out = capsys.readouterr().out
    for name in FIGURES + ("ae_best_curves.png", "mlp_best_curves.png"):
        assert f"matplotlib is not installed: {name} not written" in out
    assert not list(tmp_path.glob("*.png"))
    fin = json.loads((tmp_path / "final.json").read_text())
    assert list(fin["timings_s"]) == ["ingest", "calibrate", "fit",
                                      "evaluate"]
    for name in ("metrics.jsonl", "fit_summary.json", "validation_losses.json",
                 "mlp_results.json", "ae_global_best.msgpack",
                 "mlp_global_best.msgpack"):
        assert (tmp_path / name).exists(), name


@pytest.mark.slow
def test_quick_hard_example_within_phase_29s_band(tmp_path):
    """The port's ``--quick --synthetic-difficulty hard`` at full width on
    the CPU, against satae's run of its own example."""
    ref = json.loads(REFERENCE.read_text())
    _example("reproduce_reference_torch").main(
        ["--quick", "--synthetic-difficulty", "hard", "--out", str(tmp_path),
         "--device", "cpu"])
    fin = json.loads((tmp_path / "final.json").read_text())
    gap = abs(fin["test_accuracy"] - ref["satae"]["test_accuracy"])
    assert gap <= BAND, (fin, ref["satae"])
