"""The port's command line against satae's, on the CPU: every subcommand
with ``--device cpu`` beside satae's on one shared run directory (satae's
``fit`` at full width, synthetic data with 12 images per class, 1 AE and 1
MLP epoch), the refused multi-device flags, folder and zip ingest, the
metrics logger and the parity report.

Tolerances: file sets, stdout, classification reports, predictions CSVs,
exported tensors, decoded arrays, logger lines and report text are compared
exactly; latents within 1e-4 absolute (as tests/test_torch_port_serving.py);
reconstruction MSEs within 2e-6 (float32 sums in another order, printed to
six decimals) and reconstruction PNGs within one grey level.
"""

import contextlib
import csv
import dataclasses
import io
import json
import shutil
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from satae import cli as jcli
from satae.config import DataConfig as JaxDataConfig
from satae.data import ingest as jingest
from satae.data.synthetic import make_synthetic_eurosat
from satae.eval import parity_report as jparity
from satae.eval.metrics import per_class_metrics
from satae.utils import logging as jlog
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import api as tapi
from satae_torch import cli as tcli
from satae_torch import config as TC
from satae_torch.config import DataConfig
from satae_torch.data import ingest as tingest
from satae_torch.eval import parity_report as tparity
from satae_torch.io import native_loader
from satae_torch.utils import logging as tlog


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _common(out, cache):
    return ["--per-class", "12", "--seed", "0", "--out", str(out),
            "--cache-dir", str(cache)]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """satae's and the port's ``fit`` into run directories of their own,
    with their standard output."""
    base = tmp_path_factory.mktemp("cli")
    args = ["fit", "--ae-epochs", "1", "--mlp-epochs", "1"]
    jout = _run(jcli.main, args + _common(base / "satae", base / "jcache"))
    tout = _run(tcli.main, args + _common(base / "port", base / "tcache")
                + ["--device", "cpu"])
    return base, jout, tout


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A class tree of PNG images to serve."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(5):
        d = root / ("ClassA" if i < 3 else "ClassB")
        d.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(d / f"img{i}.png")
    return root


def _both(fits, tmp_path, argv):
    """satae's and the port's subcommand ``argv`` on copies of satae's run
    directory; returns (dirs, stdouts), the run directory's path in the
    port's stdout written as satae's."""
    base = fits[0]
    dirs = [tmp_path / "satae", tmp_path / "port"]
    for d in dirs:
        shutil.copytree(base / "satae", d)
    outs = [_run(jcli.main, argv + _common(dirs[0], base / "jcache")),
            _run(tcli.main, argv + _common(dirs[1], base / "jcache")
                 + ["--device", "cpu"])]
    return dirs, [outs[0], outs[1].replace(str(dirs[1]), str(dirs[0]))]


def _names(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


def test_fit_writes_satae_artifacts_and_stdout(fits):
    base, jout, tout = fits
    assert _names(base / "port") == _names(base / "satae")
    j, t = (json.loads(o[o.index("{"):]) for o in (jout, tout))
    assert list(t) == list(j)
    assert list(t["stage_seconds"]) == list(j["stage_seconds"])
    for k in ("ae_hparams", "mlp_hparams"):
        assert t[k] == j[k]
    jm, tm = (tlog.read_jsonl(base / d / "metrics.jsonl")
              for d in ("satae", "port"))
    assert [r["msg"][:20] for r in tm] == [r["msg"][:20] for r in jm]


def test_evaluate_matches_satae(fits, tmp_path):
    dirs, outs = _both(fits, tmp_path, ["evaluate", "--split", "test"])
    assert outs[1] == outs[0]
    assert "accuracy:" in outs[0]
    assert _names(dirs[1]) == _names(dirs[0])
    name = "classification_report_test.txt"
    assert (dirs[1] / name).read_bytes() == (dirs[0] / name).read_bytes()


def test_extract_and_report_match_satae(fits, tmp_path):
    dirs, outs = _both(fits, tmp_path, ["extract", "--plot"])
    assert outs[1] == outs[0]
    assert _names(dirs[1]) == _names(dirs[0])
    for split in ("train", "val", "test"):
        a, b = (np.load(d / f"latents_{split}.npz") for d in dirs)
        np.testing.assert_array_equal(a["y"], b["y"])
        np.testing.assert_allclose(b["X"], a["X"], rtol=0, atol=1e-4)
    for d in dirs:
        for split in ("train", "val", "test"):
            (d / f"latent_space_{split}.png").unlink()
    outs = [_run(jcli.main, ["report", "--out", str(dirs[0])]),
            _run(tcli.main, ["report", "--out", str(dirs[1])])]
    assert outs[1].replace(str(dirs[1]), str(dirs[0])) == outs[0]
    assert _names(dirs[1]) == _names(dirs[0])


def test_export_torch_matches_satae(fits, tmp_path):
    dirs, outs = _both(fits, tmp_path, ["export-torch"])
    assert outs[1] == outs[0]
    for name in ("AE_GLOBAL_BEST.pt", "MLP_GLOBAL_BEST.pt"):
        a, b = (torch.load(d / name, weights_only=True) for d in dirs)
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a), name


def test_predict_csv_equals_satae(fits, tmp_path, images):
    dirs, outs = _both(fits, tmp_path, ["predict", "--images", str(images),
                                        "--proba"])
    assert outs[1] == outs[0]
    rows = [(d / "predictions.csv").read_text() for d in dirs]
    assert rows[1] == rows[0]
    assert len(rows[0].splitlines()) == 6


def test_reconstruct_matches_satae(fits, tmp_path, images):
    dirs, outs = _both(fits, tmp_path, ["reconstruct", "--images",
                                        str(images)])
    assert outs[0].startswith("wrote 5 reconstructions")
    assert outs[1][:outs[1].index("mean MSE")] == \
        outs[0][:outs[0].index("mean MSE")]
    rec = [d / "reconstructions" for d in dirs]
    assert _names(rec[1]) == _names(rec[0])
    tables = []
    for r in rec:
        with open(r / "reconstruction_mse.csv", newline="") as f:
            tables.append(list(csv.reader(f)))
    assert tables[1][0] == tables[0][0] == ["path", "recon_path", "mse"]
    for a, b in zip(tables[0][1:], tables[1][1:]):
        assert b[0] == a[0]
        assert b[1].replace(str(rec[1]), str(rec[0])) == a[1]
        assert abs(float(b[2]) - float(a[2])) <= 2e-6
    for p in rec[0].rglob("*_recon.png"):
        a = np.asarray(Image.open(p), np.int16)
        b = np.asarray(Image.open(rec[1] / p.relative_to(rec[0])), np.int16)
        assert np.abs(a - b).max() <= 1


def test_calibrate_writes_satae_keys(fits, tmp_path):
    base = fits[0]
    argv = ["calibrate", "--n-inits", "4"]
    outs = [_run(jcli.main, argv + _common(tmp_path / "satae",
                                           base / "jcache")),
            _run(tcli.main, argv + _common(tmp_path / "port", base / "jcache")
                 + ["--device", "cpu"])]
    j, t = (json.loads(o) for o in outs)
    assert list(t) == list(j) == ["median", "mean", "p5", "p95"]
    assert all(np.isfinite(v) and v > 0 for v in t.values())
    assert _names(tmp_path / "port") == _names(tmp_path / "satae") == [
        "calibration.json", "ratio_histogram.png"]
    assert json.loads((tmp_path / "port" / "calibration.json").read_text()) \
        == t


def test_without_matplotlib(fits, tmp_path, monkeypatch, capsys):
    """Without matplotlib the figures satae draws unasked are skipped with a
    note (fit's curves in its log, calibrate's histogram on stderr) and the
    rest is written; a subcommand that draws raises ImportError."""
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    import satae_torch.eval
    monkeypatch.delitem(sys.modules, "satae_torch.eval.plots", raising=False)
    monkeypatch.delattr(satae_torch.eval, "plots", raising=False)
    base = fits[0]
    run = tmp_path / "run"
    tcli.main(["fit", "--ae-epochs", "1", "--mlp-epochs", "1", "--device",
               "cpu"] + _common(run, base / "jcache"))
    out, err = capsys.readouterr()
    for name in ("ae_best_curves", "mlp_best_curves"):
        assert f"matplotlib is not installed: {name}.png not written" in out
    assert not list(run.glob("*.png"))
    assert (run / "fit_summary.json").exists()
    tcli.main(["calibrate", "--n-inits", "2", "--device", "cpu"]
              + _common(run, base / "jcache"))
    out, err = capsys.readouterr()
    assert list(json.loads(out)) == ["median", "mean", "p5", "p95"]
    assert "ratio_histogram.png not written" in err
    assert (run / "calibration.json").exists()
    with pytest.raises(ImportError):
        tcli.main(["evaluate", "--device", "cpu"]
                  + _common(run, base / "jcache"))


@pytest.mark.parametrize("flags", [["--n-devices", "2"], ["--multihost"],
                                   ["--grid-dp", "2"]])
def test_multi_device_flags_are_refused(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="item 8"):
        tcli.main(["fit", "--out", str(tmp_path / "run"), "--device", "cpu",
                   "--cache-dir", str(tmp_path / "cache")] + flags)
    assert not list(tmp_path.iterdir())


def test_fit_grid_parallel_runs_the_vmap_engine(tmp_path, monkeypatch,
                                               capsys):
    """``fit --grid --parallel`` (refused until the vmap engine was ported)
    trains each sweep's configs at once and writes satae's artifacts; at a
    tiny size: the CLI's config cut to a tiny model, 16x16 images, batch 8,
    a 2x2 AE grid and 2 MLP lrs."""
    real = tcli._config_from_args

    def tiny(args):
        cfg = real(args)
        assert cfg.runtime.parallel_configs
        return dataclasses.replace(
            cfg, model=TC.ModelConfig(latent_dim=8, encoder_channels=(4, 8),
                                      head_hidden=16, mlp_hidden=(16, 8)),
            data=dataclasses.replace(cfg.data, image_size=16, batch_size=8),
            ae=dataclasses.replace(cfg.ae, alphas=(20.0, 35.0),
                                   learning_rates=(1e-3, 5e-3)),
            mlp=dataclasses.replace(cfg.mlp, learning_rates=(1e-3, 1e-2)))

    monkeypatch.setattr(tcli, "_config_from_args", tiny)
    engines = []
    real_search = tapi.ae_vmap_grid_search
    monkeypatch.setattr(tapi, "ae_vmap_grid_search", lambda *a, **kw: (
        engines.append("vmap"), real_search(*a, **kw))[1])
    run = tmp_path / "run"
    tcli.main(["fit", "--grid", "--parallel", "--per-class", "8",
               "--ae-epochs", "1", "--mlp-epochs", "1", "--device", "cpu",
               "--out", str(run), "--cache-dir", str(tmp_path / "cache")])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{\n"):])
    assert engines == ["vmap"]
    assert summary["ae_hparams"]["alpha"] in (20.0, 35.0)
    for name in ("validation_losses.json", "mlp_results.json",
                 "ae_global_best.msgpack", "mlp_global_best.msgpack",
                 "fit_summary.json", "metrics.jsonl"):
        assert (run / name).exists(), name
    assert len(json.loads((run / "validation_losses.json").read_text())) == 4


# -- ingest --------------------------------------------------------------------

@pytest.fixture(scope="module", params=["png", "jpg"])
def tree(request, tmp_path_factory):
    """A class tree (PNG: the PIL path; JPEG: the native loader) and a zip
    of it nested in one wrapper folder, as EuroSAT is distributed."""
    base = tmp_path_factory.mktemp(request.param)
    imgs, labels, classes = make_synthetic_eurosat(per_class=3, seed=1)
    root = base / "tree"
    for i in range(len(imgs)):
        d = root / classes[labels[i]]
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(imgs[i]).save(d / f"img_{i:04d}.{request.param}")
    zp = base / "EuroSAT.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        for p in sorted(root.rglob("*")):
            zf.write(p, arcname=f"2750/{p.relative_to(root)}")
    return root, zp


@pytest.mark.parametrize("form", ["folder", "zip"])
def test_ingest_equals_satae(tree, form, tmp_path):
    root, zp = tree
    src = str(root if form == "folder" else zp)
    if src.endswith(".jpg") or any(root.rglob("*.jpg")):
        assert native_loader.native_available()
    ours = tingest.load_dataset(DataConfig(root=src,
                                           cache_dir=str(tmp_path / "t")))
    theirs = jingest.load_dataset(JaxDataConfig(
        root=src, cache_dir=str(tmp_path / "j")))
    for f in ("images", "labels"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours.classes == theirs.classes
    # the same extracted tree and one decode cache each (its key hashes the
    # tree's absolute path)
    names = [[n for n in _names(tmp_path / d) if not n.endswith(".npz")]
             for d in "tj"]
    assert names[0] == names[1]
    assert len(list((tmp_path / "t").glob("eurosat_*.npz"))) == 1
    again = tingest.load_dataset(DataConfig(root=src,
                                            cache_dir=str(tmp_path / "t")))
    np.testing.assert_array_equal(again.images, ours.images)


def test_ingest_errors_and_synthetic_cache(tmp_path):
    with pytest.raises(FileNotFoundError, match="neither a directory"):
        tingest.load_dataset(DataConfig(root=str(tmp_path / "missing")))
    cfg = DataConfig(per_class=4, image_size=16, cache_dir=str(tmp_path))
    first = tingest.load_dataset(cfg)
    (cached,) = tmp_path.glob("synthetic_*.npz")
    again = tingest.load_dataset(cfg)
    np.testing.assert_array_equal(again.images, first.images)
    theirs = jingest.load_dataset(JaxDataConfig(
        per_class=4, image_size=16, cache_dir=str(tmp_path)))
    np.testing.assert_array_equal(theirs.images, first.images)
    # the key hashes each package's own generator source: two files
    assert len(list(tmp_path.glob("synthetic_*.npz"))) == 2


# -- logging and the parity report ---------------------------------------------

def test_metrics_logger_writes_satae_lines(tmp_path, monkeypatch):
    clock = iter([100.0, 101.25, 102.5, 103.0] * 2)
    monkeypatch.setattr("time.time", lambda: next(clock))
    outs = []
    for mod, name in ((jlog, "j"), (tlog, "t")):
        stream = io.StringIO()
        log = mod.MetricsLogger(tmp_path / name / "m.jsonl", stream=stream)
        log({"epoch": 0, "loss": 1.25, "val": float("inf")})
        log("a message line")
        log.log({"acc": 0.5}, extra="x")
        outs.append(stream.getvalue())
    assert outs[1] == outs[0]
    assert (tmp_path / "t" / "m.jsonl").read_bytes() == \
        (tmp_path / "j" / "m.jsonl").read_bytes()
    assert tlog.read_jsonl(tmp_path / "t" / "m.jsonl")[0]["val"] == \
        float("inf")


@pytest.mark.parametrize("collapse", [False, True])
def test_parity_report_text_equals_satae(tmp_path, collapse):
    cm = np.eye(10, dtype=np.int64) * 30
    cm[0, 2] = 3
    if collapse:
        cm[1, 1], cm[1, 9] = 1, 29
    m = per_class_metrics(cm)
    texts = [mod.write_parity_report(m, cm, mod.REFERENCE_CLASSES,
                                     tmp_path / f"{i}.md", test_acc=0.8)
             for i, mod in enumerate((jparity, tparity))]
    assert texts[1] == texts[0]
    assert tparity.forest_sealake_confusion(cm, tparity.REFERENCE_CLASSES) \
        == jparity.forest_sealake_confusion(cm, jparity.REFERENCE_CLASSES)
    tparity.check_parity_gate(0.75)
    with pytest.raises(AssertionError, match="parity miss"):
        tparity.check_parity_gate(0.74)
