"""The last of satae's public names in the port, each held against satae's
own on the same input:

  * ``satae_torch.io.checkpoint.load_pytree`` on files satae's
    ``save_pytree`` wrote (dicts, a list, a tuple, a numpy scalar): the same
    tree from a matching template, the same tree from a template that lacks
    keys (flax drops them), and ``ValueError`` in both where the file lacks
    one of the template's keys (``GridResultStore.best``:
    tests/test_torch_port_grid.py, on the stores satae's sweeps write);
  * ``satae_torch.utils.profiling.Stopwatch`` under one fake clock in both
    modules: the same ``times`` and ``report()``;
  * ``satae_torch.utils.profiling.trace``: satae's
    test_profiler_trace_writes_files on the CPU, the Chrome trace's content,
    and a profiler that does not start raising;
  * ``satae_torch.api.serve_chunk`` and ``SatAEPipeline._serve_chunk``
    against satae's ``_serve_chunk`` on stubs, batch 64, 1-4 devices (the
    unweighted DP eval step: tests/test_torch_port_parallel.py).
"""

import json
import types

import numpy as np
import pytest
import torch

from satae.api import SatAEPipeline as JaxPipeline
from satae.io import checkpoint as jckpt
from satae.models.supervised_ae import supervised_ae_init
from satae.utils import profiling as jprof
from satae import config as JC
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch.api import SatAEPipeline, serve_chunk
from satae_torch.io.checkpoint import load_pytree
from satae_torch.utils import profiling
from test_torch_port_models import numpy_trees

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))


def _assert_same_tree(a, b, at="/"):
    assert type(a) is type(b), at
    if isinstance(a, dict):
        assert list(a) == list(b), at
        for k in a:
            _assert_same_tree(a[k], b[k], f"{at}{k}/")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), at
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{at}{i}/")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, at
        np.testing.assert_array_equal(a, b, err_msg=at)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    params, state = numpy_trees(supervised_ae_init, JCFG, image_size=16,
                                seed=3)
    tree = {"params": params, "bn_state": state,
            "extra": [np.arange(3, dtype=np.int32),
                      (np.float32(2.5), np.ones((2, 2), np.float32))]}
    path = tmp_path_factory.mktemp("pytree") / "tree.msgpack"
    jckpt.save_pytree(path, tree)
    return path, tree


def test_load_pytree_matches_satae(saved):
    path, tree = saved
    ours, theirs = load_pytree(path, tree), jckpt.load_pytree(path, tree)
    _assert_same_tree(ours, theirs)
    _assert_same_tree(ours["params"], tree["params"])
    assert isinstance(ours["params"]["encoder"]["conv0"]["w"], np.ndarray)


def test_load_pytree_template_without_a_key(saved):
    """flax restores the template's keys only: one the template lacks is
    dropped, at the top and deeper down, in both packages."""
    path, tree = saved
    like = {"params": {k: v for k, v in tree["params"].items()
                       if k != "decoder"}, "extra": tree["extra"]}
    ours, theirs = load_pytree(path, like), jckpt.load_pytree(path, like)
    _assert_same_tree(ours, theirs)
    assert set(ours) == {"params", "extra"}
    assert "decoder" not in ours["params"]


@pytest.mark.parametrize("like", ["top", "nested", "list"])
def test_load_pytree_file_without_a_key_raises(saved, like):
    path, tree = saved
    if like == "top":
        bad = {**tree, "opt_state": {}}
    elif like == "nested":
        bad = {**tree, "bn_state": {**tree["bn_state"], "extra_bn": {}}}
    else:
        bad = {**tree, "extra": tree["extra"] + [np.zeros(1)]}
    with pytest.raises(ValueError):
        jckpt.load_pytree(path, bad)
    with pytest.raises(ValueError):
        load_pytree(path, bad)


def test_stopwatch_matches_satae(monkeypatch):
    """One fake clock in both modules, repeated and nested stages: the same
    accumulated times and the same 3-decimal report."""
    def clock():
        ticks = iter(np.cumsum([0.1, 0.2503, 1.00049, 0.3, 0.0004, 2.12345,
                                0.7, 0.05]))
        return lambda: float(next(ticks))

    reports = []
    for mod in (jprof, profiling):
        monkeypatch.setattr(mod.time, "perf_counter", clock())
        sw = mod.Stopwatch()
        with sw.stage("ingest"):
            pass
        with sw.stage("fit"):
            with sw.stage("calibrate"):
                pass
        with sw.stage("ingest"):
            pass
        reports.append((dict(sw.times), sw.report()))
    assert reports[0] == reports[1]
    times, report = reports[1]
    assert list(report) == ["ingest", "calibrate", "fit"]
    assert report == {k: round(v, 3) for k, v in times.items()}


def test_profiler_trace_writes_files(tmp_path):
    """satae's test_profiler_trace_writes_files on the port: a 64x64 product
    inside ``trace``, a Chrome trace written into a directory it makes."""
    out = tmp_path / "new" / "trace"
    with profiling.trace(str(out)):
        torch.ones((64, 64)) @ torch.ones((64, 64))
    files = [p for p in out.rglob("*") if p.is_file()]
    assert files, "no trace artifacts written"
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::matmul" in names


def test_profiler_that_does_not_start_raises(tmp_path, monkeypatch):
    def refuse(self):
        raise RuntimeError("profiler refused")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler.profile, "start", refuse)
        with pytest.raises(RuntimeError, match="profiler refused"):
            with profiling.trace(tmp_path):
                pass
    with monkeypatch.context() as m:
        m.setattr(torch.autograd, "_profiler_enabled", lambda: False)
        with pytest.raises(RuntimeError, match="did not start"):
            with profiling.trace(tmp_path):
                pass
    assert not torch.autograd._profiler_enabled()


@pytest.mark.parametrize("devices", [1, 2, 3, 4])
def test_serve_chunk_matches_satae(devices):
    """satae's small chunk holds while n fits one batch rounded up to the
    devices: at 3 devices and batch 64, n = 65 and 66 pad to 66, not 513."""
    jstub = types.SimpleNamespace(
        config=types.SimpleNamespace(data=types.SimpleNamespace(
            batch_size=64)), _encode_pad=devices)
    tstub = types.SimpleNamespace(config=types.SimpleNamespace(
        data=types.SimpleNamespace(batch_size=64),
        runtime=types.SimpleNamespace(n_devices=devices)))
    for n in (1, 64, 65, 66, 67, 513):
        want = JaxPipeline._serve_chunk(jstub, n)
        assert serve_chunk(n, 64, devices) == want, n
        assert SatAEPipeline._serve_chunk(tstub, n) == want, n
    if devices == 3:
        assert [serve_chunk(n, 64, 3) for n in (64, 65, 66, 67)] == \
            [66, 66, 66, 513]
