"""The port's run directory against satae's, on the CPU at the tiny config of
tests/test_torch_port_fit.py (a 2x2 AE grid, 2 MLP lrs, 2 epochs each):

(a) the msgpack writer gives flax's bytes; (b) the carry-over between the
reference state_dict and satae's trees is exact both ways; (d) a run
directory the port writes loads, and resumes without training, in satae;
(e) one satae writes resumes in the port without training, its winner read
bit for bit and its MLP store kept by the fingerprint guard; (f) evaluate,
save and export agree with satae's on the same weights. The strict-JSON
helpers, the store keys and the metrics are held against satae's too.

Tolerances: bytes, trees, stores, predictions, confusion matrices and
reports are compared exactly; latents within 1e-4 absolute, as in
tests/test_torch_port_serving.py (float32 sums in another order).
"""

import dataclasses
import hashlib
import json
import shutil

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from satae import config as JC
from satae.api import SatAEPipeline as JaxPipeline
from satae.data.pipeline import ArrayDataset as JaxArrayDataset
from satae.eval import metrics as JM
from satae.io import checkpoint as jckpt
from satae.io.torch_import import (load_torch_mlp, load_torch_sae,
                                   mlp_from_torch_state_dict,
                                   sae_from_torch_state_dict)
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from satae.train import fast_loop as jfast
from satae.utils import strict_json as jjson
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.api import SatAEPipeline
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.eval import metrics as TM
from satae_torch.io import checkpoint, convert
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn.init import init_
from satae_torch.train import fast_loop as tfast
from satae_torch.utils import strict_json as tjson
from test_torch_port_models import numpy_trees

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, B = 16, 8
GRID = dict(alphas=(20.0, 35.0), learning_rates=(1e-3, 5e-3), max_epochs=2)
MLP_GRID = dict(learning_rates=(1e-3, 1e-2), epochs=2)
CFG = TC.PipelineConfig(
    data=TC.DataConfig(per_class=8, image_size=IMG, batch_size=B),
    model=TCFG, ae=TC.AETrainConfig(**GRID), mlp=TC.MLPTrainConfig(**MLP_GRID))
JCFG_PIPE = JC.PipelineConfig(
    data=JC.DataConfig(per_class=8, image_size=IMG, batch_size=B),
    model=JCFG, ae=JC.AETrainConfig(**GRID),
    mlp=JC.MLPTrainConfig(**MLP_GRID))
SUMMARY_FIELDS = ("ae_val_loss", "ae_hparams", "mlp_val_acc", "mlp_hparams",
                  "test_acc")


@pytest.fixture(scope="module")
def test_split():
    return make_splits(load_dataset(CFG.data), CFG.data).test


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port grid fit's run directory and its FitSummary."""
    run = tmp_path_factory.mktemp("port") / "run"
    summary = SatAEPipeline(CFG, device="cpu").fit(grid=True, out_dir=str(run))
    return run, summary


@pytest.fixture(scope="module")
def satae_run(tmp_path_factory):
    """A satae grid fit's run directory and its FitSummary."""
    run = tmp_path_factory.mktemp("satae") / "run"
    summary = JaxPipeline(JCFG_PIPE).fit(grid=True, out_dir=str(run))
    return run, summary


def _copy(run, tmp_path):
    dst = tmp_path / "copy"
    shutil.copytree(run, dst)
    return dst


def _refuse_training(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a cached config was trained again")
    for mod, names in ((tfast, ("train_supervised_ae", "train_mlp")),
                       (jfast, ("train_supervised_ae_scan",
                                "train_mlp_scan"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


# -- (a) the writer ---------------------------------------------------------

def _edge_tree():
    """Every header form: ints, strings and maps at msgpack's size
    boundaries, ext payloads of 16 bytes (fixext), < 256, < 65536 and
    larger, a transposed (non-contiguous) array, numpy scalars."""
    rng = np.random.default_rng(0)
    ints = (0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -1, -32,
            -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, 2**64 - 1,
            -2**63)
    return {
        "ints": {str(v): v for v in ints},
        "strs": {str(n): "x" * n for n in (0, 31, 32, 255, 256, 70000)},
        "wide_map": {f"k{i}": float(i) for i in range(20)},
        "scalar_arrays": {"f32": np.array(2.0, np.float32),
                          "i8": np.array([3], np.int8)},
        "numpy_scalars": {"f32": np.float32(1.5), "f64": np.float64(2.5),
                          "i64": np.int64(7), "bool": np.bool_(True)},
        "arrays": {"f32x100": rng.standard_normal(100).astype(np.float32),
                   "f32x20000": rng.standard_normal(20000).astype(np.float32),
                   "transposed": rng.standard_normal((3, 5)).astype(
                       np.float32).T,
                   "i16": np.arange(6, dtype=np.int16).reshape(2, 3)},
        "other": {"none": None, "true": True, "false": False, "float": 0.1,
                  "bytes": b"\x00" * 300},
    }


def _writer_case(name):
    ae = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=1)
    mlp = numpy_trees(mlp_init, JCFG, seed=2)
    return {"ae_params": ae[0], "ae_bn_state": ae[1], "mlp_params": mlp[0],
            "mlp_bn_state": mlp[1],
            "ae_blob": {"params": ae[0], "bn_state": ae[1]},
            "mlp_blob": {"params": mlp[0], "bn_state": mlp[1]},
            "encoder_fingerprint": {"p": ae[0]["encoder"],
                                    "s": ae[1]["encoder"]},
            "edge": _edge_tree()}[name]


@pytest.mark.parametrize("name", ["ae_params", "ae_bn_state", "mlp_params",
                                  "mlp_bn_state", "ae_blob", "mlp_blob",
                                  "encoder_fingerprint", "edge"])
def test_packb_is_flax_bytes(name):
    tree = _writer_case(name)
    ours = checkpoint.packb(tree)
    assert ours == flax.serialization.to_bytes(jax.device_get(tree))
    _assert_trees_equal(
        jax.tree_util.tree_map(np.asarray, checkpoint.unpackb(ours)),
        jax.tree_util.tree_map(np.asarray, flax.serialization.msgpack_restore(
            ours)))


def test_packb_refuses_what_flax_would_not_round_trip():
    for bad in ({"l": [np.zeros(2)]}, {"t": torch.zeros(2)},
                {"c": np.zeros(2, np.complex64)}):
        with pytest.raises(TypeError):
            checkpoint.packb(bad)


@pytest.mark.parametrize("meta", [None, {"alpha": 20.0, "lr": 1e-3,
                                         "best_val_loss": float("inf")}])
def test_save_model_files_equal_satae(tmp_path, meta):
    p, s = numpy_trees(supervised_ae_init, JCFG, image_size=IMG, seed=3)
    checkpoint.save_model(tmp_path / "port" / "m.msgpack", p, s, meta=meta)
    jckpt.save_model(tmp_path / "satae" / "m.msgpack", p, s, meta=meta)
    names = sorted(f.name for f in (tmp_path / "satae").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "satae" / n).read_bytes()


# -- (b) the carry-over ------------------------------------------------------

@pytest.mark.parametrize("kind", ["ae", "mlp"])
def test_state_dict_tree_round_trip_is_exact(kind):
    if kind == "ae":
        model = SupervisedAE(TCFG, image_size=IMG)
        back = lambda sd: convert.sae_from_torch_state_dict(
            sd, TCFG, image_size=IMG)
        forth = lambda p, s: convert.sae_to_torch_state_dict(
            p, s, TCFG, image_size=IMG)
        ref = lambda sd: sae_from_torch_state_dict(sd, JCFG, image_size=IMG)
    else:
        model = MLP(TCFG)
        back = lambda sd: convert.mlp_from_torch_state_dict(sd, TCFG)
        forth = lambda p, s: convert.mlp_to_torch_state_dict(p, s, TCFG)
        ref = lambda sd: mlp_from_torch_state_dict(sd, JCFG)
    init_(model, torch.Generator().manual_seed(4))
    with torch.no_grad():  # non-trivial running statistics
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    sd = model.state_dict()
    trees = back(sd)
    _assert_trees_equal(trees, ref(sd))
    again = convert.to_tensors(forth(*trees))
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k
    _assert_trees_equal(back(again), trees)


# -- (d) from the port to satae ------------------------------------------------

def test_port_run_dir_loads_and_resumes_in_satae(port_run, test_split,
                                                 tmp_path, monkeypatch):
    run, summary = port_run
    ours = SatAEPipeline(CFG, device="cpu").load(str(run))
    theirs = JaxPipeline(JCFG_PIPE).load(str(run))
    np.testing.assert_array_equal(theirs.predict(test_split.images),
                                  ours.predict(test_split.images))
    np.testing.assert_allclose(theirs.encode(test_split.images),
                               ours.encode(test_split.images), atol=1e-4)
    assert theirs.classes == ours.classes

    run = _copy(run, tmp_path)
    kept = {n: (run / n).read_bytes() for n in (
        "mlp_results.json", "mlp_provenance.json", "validation_losses.json",
        "ae_global_best.msgpack", "mlp_global_best.msgpack")}
    _refuse_training(monkeypatch)
    lines = []
    resumed = JaxPipeline(JCFG_PIPE).fit(grid=True, out_dir=str(run),
                                         log=lines.append)
    assert len(lines) == 6 and all(ln.startswith("skip cached")
                                   for ln in lines)
    for f in SUMMARY_FIELDS:
        assert getattr(resumed, f) == getattr(summary, f), f
    for n, data in kept.items():  # the fingerprints agreed: nothing cleared
        assert (run / n).read_bytes() == data, n


def test_single_config_fit_writes_satae_run_dir(test_split, tmp_path):
    """fit(grid=False, out_dir=...) writes what satae's single-config fit
    writes: both winners with their selection meta, the summary, the
    classes and the two curve figures; satae loads the directory and
    predicts the same."""
    run = tmp_path / "run"
    pipe = SatAEPipeline(dataclasses.replace(CFG, ae=TC.AETrainConfig(
        max_epochs=2), mlp=TC.MLPTrainConfig(epochs=2)), device="cpu")
    summary = pipe.fit(out_dir=str(run))
    assert sorted(f.name for f in run.iterdir()) == [
        "ae_best_curves.png", "ae_global_best.json",
        "ae_global_best.msgpack", "classes.json", "fit_summary.json",
        "mlp_best_curves.png", "mlp_global_best.json",
        "mlp_global_best.msgpack", "mlp_provenance.json"]
    ae_meta = json.loads((run / "ae_global_best.json").read_text())
    mlp_meta = json.loads((run / "mlp_global_best.json").read_text())
    assert ae_meta["alpha"] == 35.0 and ae_meta["lr"] == 5e-3
    assert ae_meta["best_val_loss"] == summary.ae_val_loss
    assert mlp_meta["lr"] == 1e-4
    assert mlp_meta["best_val_acc"] == summary.mlp_val_acc
    assert json.loads((run / "fit_summary.json").read_text())[
        "ae_hparams"] == summary.ae_hparams
    np.testing.assert_array_equal(
        JaxPipeline(JCFG_PIPE).load(str(run)).predict(test_split.images),
        pipe.predict(test_split.images))


# -- (e) from satae to the port ------------------------------------------------

def test_satae_run_dir_resumes_in_the_port(satae_run, test_split, tmp_path,
                                           monkeypatch):
    src, jsummary = satae_run
    run = _copy(src, tmp_path)
    kept = {n: (run / n).read_bytes() for n in (
        "mlp_results.json", "mlp_provenance.json", "validation_losses.json",
        "ae_global_best.msgpack", "ae_global_best.json",
        "mlp_global_best.msgpack", "mlp_global_best.json")}
    _refuse_training(monkeypatch)
    lines = []
    pipe = SatAEPipeline(CFG, device="cpu")
    summary = pipe.fit(grid=True, out_dir=str(run), log=lines.append)
    assert len(lines) == 6 and all(ln.startswith("skip cached")
                                   for ln in lines)
    for n, data in kept.items():
        assert (run / n).read_bytes() == data, n
    for f in SUMMARY_FIELDS:
        assert getattr(summary, f) == getattr(jsummary, f), f
    # the winners, bit for bit
    jp = JaxPipeline(JCFG_PIPE).load(str(src))
    _assert_trees_equal(convert.sae_from_torch_state_dict(
        pipe.ae.state_dict(), TCFG, image_size=IMG),
        (jp.ae_params, jp.ae_bn_state))
    _assert_trees_equal(convert.mlp_from_torch_state_dict(
        pipe.mlp.state_dict(), TCFG), (jp.mlp_params, jp.mlp_bn_state))
    np.testing.assert_array_equal(pipe.predict(test_split.images),
                                  jp.predict(test_split.images))


def test_fingerprint_guard_agrees_with_satae(satae_run, tmp_path):
    """Both packages stamp the same fingerprint for the same encoder, and
    both clear the MLP store for another one."""
    src, _ = satae_run
    jp = JaxPipeline(JCFG_PIPE).load(str(src))
    tp = SatAEPipeline(CFG, device="cpu").load(str(src))
    for pkg, pipe in (("satae", jp), ("port", tp)):
        pipe._guard_mlp_store(str(tmp_path / pkg))
    assert (tmp_path / "port" / "mlp_provenance.json").read_text() == \
        (src / "mlp_provenance.json").read_text() == \
        (tmp_path / "satae" / "mlp_provenance.json").read_text()
    enc = {"p": jp.ae_params["encoder"], "s": jp.ae_bn_state["encoder"]}
    assert json.loads((src / "mlp_provenance.json").read_text())[
        "ae_fingerprint"] == hashlib.sha1(checkpoint.packb(enc)).hexdigest()

    run = _copy(src, tmp_path)
    other = SatAEPipeline(CFG, device="cpu")
    other.ae, other.mlp = SupervisedAE(TCFG, image_size=IMG).eval(), None
    other._guard_mlp_store(str(run))
    for name in ("mlp_results.json", "mlp_global_best.msgpack",
                 "mlp_global_best.json"):
        assert not (run / name).exists(), name


# -- (f) reports, sidecars, export ---------------------------------------------

def test_evaluate_matches_satae(satae_run, test_split):
    src, _ = satae_run
    ours = SatAEPipeline(CFG, device="cpu").load(str(src)).evaluate(
        test_split)
    theirs = JaxPipeline(JCFG_PIPE).load(str(src)).evaluate(
        JaxArrayDataset(test_split.images, test_split.labels))
    assert set(ours) == set(theirs)
    assert ours["confusion_matrix"].dtype == np.int64
    np.testing.assert_array_equal(ours["confusion_matrix"],
                                  theirs["confusion_matrix"])
    assert ours["report"] == theirs["report"]
    for k in ours:
        if k not in ("confusion_matrix", "report"):
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_save_keeps_or_removes_sidecars_as_satae(port_run, tmp_path):
    src, _ = port_run
    run = _copy(src, tmp_path)
    before = {f.name: f.read_bytes() for f in run.iterdir()}
    # saving the weights back where they came from keeps the meta, and the
    # checkpoints come out as the same bytes
    SatAEPipeline(CFG, device="cpu").load(str(run)).save(str(run))
    assert {f.name: f.read_bytes() for f in run.iterdir()} == before
    # saving them over another run's files removes that run's meta
    other = tmp_path / "other"
    shutil.copytree(run, other)
    pipe = SatAEPipeline(CFG, device="cpu").load(str(run))
    pipe.save(str(other))
    assert not (other / "ae_global_best.json").exists()
    assert not (other / "mlp_global_best.json").exists()
    for n in ("ae_global_best.msgpack", "mlp_global_best.msgpack"):
        assert (other / n).read_bytes() == before[n]
    # an AE-only pipeline writes the autoencoder alone
    ae_only = tmp_path / "ae_only"
    fresh = SatAEPipeline(CFG, device="cpu").load_ae(str(run))
    fresh.save(str(ae_only))
    assert sorted(f.name for f in ae_only.iterdir()) == [
        "ae_global_best.msgpack", "classes.json"]


def test_export_torch_matches_satae(port_run, test_split, tmp_path):
    src, _ = port_run
    ours = SatAEPipeline(CFG, device="cpu").load(str(src))
    ours.export_torch(str(tmp_path / "port"))
    JaxPipeline(JCFG_PIPE).load(str(src)).export_torch(
        str(tmp_path / "satae"))
    for name in ("AE_GLOBAL_BEST.pt", "MLP_GLOBAL_BEST.pt"):
        a = torch.load(tmp_path / "port" / name, weights_only=True)
        b = torch.load(tmp_path / "satae" / name, weights_only=True)
        assert list(a) == list(b), name
        for k in b:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
            assert a[k].device.type == "cpu"
        assert all(int(v) == 0 for k, v in a.items()
                   if k.endswith("num_batches_tracked"))
    # satae's importer and the port's strict loader both take the files
    ae_p, ae_s = load_torch_sae(str(tmp_path / "port" / "AE_GLOBAL_BEST.pt"),
                                JCFG, image_size=IMG)
    _assert_trees_equal((ae_p, ae_s), convert.sae_from_torch_state_dict(
        ours.ae.state_dict(), TCFG, image_size=IMG))
    load_torch_mlp(str(tmp_path / "port" / "MLP_GLOBAL_BEST.pt"), JCFG)
    back = SatAEPipeline(CFG, device="cpu").load_torch(
        str(tmp_path / "port" / "AE_GLOBAL_BEST.pt"),
        str(tmp_path / "port" / "MLP_GLOBAL_BEST.pt"))
    np.testing.assert_array_equal(back.predict(test_split.images),
                                  ours.predict(test_split.images))


# -- helpers held against satae's ----------------------------------------------

@pytest.mark.parametrize("obj", [
    {"a": float("inf"), "b": [float("-inf"), float("nan"), 1.5], "c": "x"},
    [1, 2.5, {"d": float("nan")}], {"alpha": 20.0, "lr": 0.001}])
def test_strict_json_and_store_keys_equal_satae(obj, tmp_path):
    assert tjson.dump_strict_json(obj, indent=2) == \
        jjson.dump_strict_json(obj, indent=2)
    text = tjson.dump_strict_json(obj)
    assert json.dumps(tjson.json_restore(json.loads(text))) == json.dumps(
        jjson.json_restore(json.loads(text)))
    if isinstance(obj, dict) and "alpha" in obj:
        assert checkpoint.GridResultStore.key(lr=0.001, alpha=20.0) == \
            jckpt.GridResultStore.key(lr=0.001, alpha=20.0)
        for pkg, store in (("port", checkpoint.GridResultStore),
                           ("satae", jckpt.GridResultStore)):
            s = store(tmp_path / pkg / "store.json")
            s.record(store.key(**obj), {**obj, "best_val_loss": float("nan")})
        assert (tmp_path / "port" / "store.json").read_text() == \
            (tmp_path / "satae" / "store.json").read_text()
        loaded = checkpoint.load_grid_results(tmp_path / "satae" /
                                              "store.json")
        assert np.isnan(loaded[checkpoint.GridResultStore.key(**obj)][
            "best_val_loss"])


@pytest.mark.parametrize("names", [None, JC.EUROSAT_CLASSES])
def test_metrics_match_satae(names):
    rng = np.random.default_rng(5)
    y_true = rng.integers(0, 10, 200)
    y_pred = np.where(rng.random(200) < 0.6, y_true,
                      rng.integers(0, 10, 200))
    y_pred[y_pred == 3] = 4  # a class never predicted: 0/0 precision
    y_true[:3] = 10  # out of range: counted nowhere
    cm = TM.confusion_matrix(y_true, y_pred, 10)
    np.testing.assert_array_equal(cm, JM.confusion_matrix(y_true, y_pred, 10))
    ours, theirs = TM.per_class_metrics(cm), JM.per_class_metrics(cm)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert TM.classification_report(y_true, y_pred, 10, names) == \
        JM.classification_report(y_true, y_pred, 10, names)
