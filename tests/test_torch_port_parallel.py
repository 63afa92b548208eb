"""The port's multi-device runtime (satae_torch.parallel) on the CPU: two
ranks over Gloo, each a process of its own (tests/torch_port_dp_worker.py),
held against satae's mesh functions on two of the 8 virtual CPU devices
that tests/conftest.py provides, and against the port's own one-process
results on the same global batches.

  * the process-model units, mirroring tests/test_distributed.py: no
    initialization by default, the flag and the environment variable,
    idempotence, a failed initialization propagating, ``process_info``, the
    world check and the mesh's rank layout;
  * the data-parallel AE step: 3 steps against satae's
    ``make_dp_ae_train_step`` from the same weights and satae's
    augmentation draws, at tests/test_torch_port_train.py's tolerances, and
    one step against the port's one-process step on the same global batch
    and generator (loss rtol 1e-5, BatchNorm running stats 1e-5, parameters
    2.1e-3, tests/test_parallel.py's bound);
  * the weighted eval, extraction and serving (encode, predict,
    predict_proba, decode, reconstruct) at sizes that do not divide by 2,
    against satae's mesh functions;
  * the DP scan-epoch and per-batch trainers against the port's one-process
    trainers in tests/test_parallel.py's scan-epoch setup.

The CLI on two ranks: tests/test_torch_port_parallel_cli.py; the sharded
sweeps: tests/test_torch_port_shard_sweep.py.

Every two-rank body runs in one spawn per module (~5 s of process start).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from satae import config as JC
from satae.api import SatAEPipeline as JaxPipeline
from satae.data.pipeline import ArrayDataset as JaxArrayDataset
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from satae.parallel import make_mesh as jax_make_mesh
from satae.parallel import shard_batch as jax_shard_batch
from satae.parallel.dp import (make_dp_ae_eval_step_weighted as
                               jax_dp_eval_weighted)
from satae.parallel.dp import make_dp_ae_eval_step as jax_dp_eval
from satae.parallel.dp import make_dp_ae_train_step as jax_dp_train_step
from satae.parallel.dp import make_dp_encode_step as jax_dp_encode_step
from satae.train.extract import extract_features as jax_extract
from satae.train.optim import adam_init as jax_adam_init
from torch_port_threads import two_threads  # noqa: F401 (autouse)
import torch_port_dp_worker as W
from satae_torch import config as TC
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.io import convert
from satae_torch.io.convert import sae_to_torch_state_dict, to_tensors
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.parallel import Mesh, distributed, make_mesh, shard_batch
from satae_torch.parallel.dp import make_dp_ae_eval_step
from satae_torch.train import fast_loop, loop
from satae_torch.train.optim import adam_init
from satae_torch.train.steps import ae_eval_step, ae_train_step
from test_torch_port_models import numpy_trees
from test_torch_port_train import (_assert_state_close, _PreBNBiases,
                                   _satae_aug_draws)

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, GB = 16, 16  # image size, global batch (8 rows a rank)
JDATA = JC.DataConfig(image_size=IMG, batch_size=GB)
TDATA = TC.DataConfig(image_size=IMG, batch_size=GB)
ALPHA, LR, STEPS = 35.0, 5e-3, 3
# tests/test_parallel.py's scan-epoch setup
SCAN_J = JC.ModelConfig(latent_dim=16, encoder_channels=(4, 8, 8, 16))
SCAN_T = TC.ModelConfig(**dataclasses.asdict(SCAN_J))
SCAN_DATA = TC.DataConfig(per_class=16, image_size=32, batch_size=32)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _u8(n, seed, size=IMG):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


# -- the process model ---------------------------------------------------------

@pytest.fixture
def fresh(monkeypatch):
    """No process group, no initialization flag, no launcher environment;
    whatever group a test makes is destroyed after it."""
    up = dist.is_initialized  # spy_init replaces it
    assert not up()
    monkeypatch.setattr(distributed, "_initialized", False)
    for var in ("SATAE_MULTIHOST", "RANK", "WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    yield
    if up():
        dist.destroy_process_group()


@pytest.fixture
def spy_init(fresh, monkeypatch):
    calls = []
    state = {"up": False}

    def init(backend, init_method=None, **kw):
        calls.append((backend, init_method))
        state["up"] = True

    monkeypatch.setattr(distributed.dist, "init_process_group", init)
    monkeypatch.setattr(distributed.dist, "is_initialized",
                        lambda: state["up"])
    return calls


def test_single_process_default_untouched(spy_init):
    assert distributed.maybe_initialize() is False
    assert distributed.maybe_initialize(False, "cpu") is False
    assert spy_init == []


def test_flag_initializes_once(spy_init):
    assert distributed.maybe_initialize(True, "cpu") is True
    assert distributed.maybe_initialize(True, "cpu") is True  # idempotent
    assert distributed.maybe_initialize() is True  # already up wins
    assert spy_init == [("gloo", "env://")]


def test_env_var_requests_and_backend_follows_the_device(monkeypatch,
                                                         spy_init):
    monkeypatch.setenv("SATAE_MULTIHOST", "1")
    assert distributed.multihost_requested() is True
    monkeypatch.setattr(distributed, "local_device", lambda d: d)
    assert distributed.maybe_initialize(None, "cuda") is True
    assert spy_init == [("nccl", "env://")]
    for v in ("0", "false", "no", ""):
        monkeypatch.setenv("SATAE_MULTIHOST", v)
        assert distributed.multihost_requested() is False


def test_initialize_failure_propagates(fresh, monkeypatch):
    """A half-wired multi-process run fails loudly instead of training on
    1/N of the data: without torchrun's environment, env:// raises."""
    with pytest.raises(ValueError, match="env://"):
        distributed.maybe_initialize(True, "cpu")
    assert distributed._initialized is False
    assert not dist.is_initialized()


def test_process_info_and_world_checks(fresh):
    info = distributed.process_info()
    assert info == {"process_index": 0, "process_count": 1,
                    "local_device_count": 1, "global_device_count": 1}
    assert distributed.is_primary()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_mesh(2, device="cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")  # a group of its own, in process
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert (mesh.data_size, mesh.data_rank, mesh.row, mesh.src) == (1, 0, 0, 0)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    # cuda without an index is this rank's device within a group
    assert distributed.local_device("cpu") == CPU


def test_grid_mesh_rank_layout():
    """rank = c * n_data + d: the data axis innermost (satae's mesh.py:37-42);
    each rank's collectives run over its config row, whose first rank
    broadcasts; shard_batch takes its rows."""
    rows = []
    for rank in range(6):
        m = Mesh(("config", "data"), {"config": 3, "data": 2}, rank, None)
        rows.append((m.row, m.data_rank, m.src, m.data_size))
    assert rows == [(0, 0, 0, 2), (0, 1, 0, 2), (1, 0, 2, 2), (1, 1, 2, 2),
                    (2, 0, 4, 2), (2, 1, 4, 2)]
    m = Mesh(("data",), {"data": 4}, 3, None)
    x = np.arange(8)
    assert (m.row, m.data_rank, m.src) == (0, 3, 0)
    np.testing.assert_array_equal(shard_batch(m, x), [6, 7])
    a, b = shard_batch(m, x, x * 2)
    np.testing.assert_array_equal(b, [12, 14])
    with pytest.raises(ValueError, match="do not divide"):
        m.shard(np.arange(6))


# -- two ranks -----------------------------------------------------------------

def _satae_steps():
    """satae's DP step on 2 virtual devices from its init: the trees before
    each step, the metrics, the final trees; and the port's payloads."""
    key = jax.random.PRNGKey(0)
    params, state = supervised_ae_init(key, JCFG, image_size=IMG)
    sd = to_tensors(sae_to_torch_state_dict(params, state, TCFG, IMG))
    step = jax_dp_train_step(jax_make_mesh(2), JCFG, JDATA, donate=False)
    opt = jax_adam_init(params)
    rng = np.random.default_rng(0)
    steps, pre, metrics = [], [], []
    for s in range(STEPS):
        imgs, labels = _u8(GB, 20 + s), rng.integers(0, 10, GB)
        k = jax.random.fold_in(key, s)
        pre.append(sae_to_torch_state_dict(jax.device_get(params),
                                           jax.device_get(state), TCFG, IMG))
        x, y = jax_shard_batch(jax_make_mesh(2), imgs,
                               np.asarray(labels, np.int32))
        params, state, opt, m = step(params, state, opt, x, y, k,
                                     jnp.float32(ALPHA), jnp.float32(LR))
        metrics.append({n: float(v) for n, v in m.items()})
        draws = _satae_aug_draws(k, GB)
        steps.append((_t(imgs), _t(labels), draws))
    final = sae_to_torch_state_dict(jax.device_get(params),
                                    jax.device_get(state), TCFG, IMG)
    return sd, steps, pre, metrics, final


@pytest.fixture(scope="module")
def serving_run(tmp_path_factory):
    run = tmp_path_factory.mktemp("dp_run")
    jp = JaxPipeline(JC.PipelineConfig(data=JC.DataConfig(image_size=IMG),
                                       model=JCFG))
    jp.ae_params, jp.ae_bn_state = numpy_trees(supervised_ae_init, JCFG,
                                               image_size=IMG, seed=5)
    jp.mlp_params, jp.mlp_bn_state = numpy_trees(mlp_init, JCFG, seed=6)
    jp.save(str(run))
    return run


@pytest.fixture(scope="module")
def scan_splits():
    return make_splits(load_dataset(SCAN_DATA), SCAN_DATA)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, serving_run, scan_splits):
    """Every two-rank body of this module in one spawn."""
    sd, steps, pre, metrics, final = _satae_steps()
    one_step = [(_t(_u8(GB, 30)), _t(np.arange(GB) % 10), None)]
    payload = {
        "satae_steps": ("dp_ae_steps", dict(
            model_cfg=TCFG, data_cfg=TDATA, sd=sd, steps=steps, alpha=ALPHA,
            lr=LR, seed=0)),
        "own_steps": ("dp_ae_steps", dict(
            model_cfg=TCFG, data_cfg=TDATA, sd=sd, steps=one_step,
            alpha=ALPHA, lr=1e-3, seed=0)),
        "serving": ("dp_serving", dict(
            run=str(serving_run), cfg=TC.PipelineConfig(
                data=TC.DataConfig(image_size=IMG, batch_size=8),
                model=TCFG),
            images=_t(_u8(13, 40)), labels=_t(np.arange(13) % 10),
            extract=_t(_u8(21, 41)), alpha=ALPHA, batch_size=8)),
        "eval": ("dp_eval", dict(
            model_cfg=TCFG, sd=sd, images=_t(_u8(GB, 50)),
            labels=_t(np.arange(GB) % 10), alpha=ALPHA)),
        "trainers": ("dp_trainers", dict(
            model_cfg=SCAN_T, data_cfg=SCAN_DATA, train=scan_splits.train,
            val=scan_splits.val, alpha=35.0, lr=2e-3, epochs=2)),
    }
    ranks = W.run(2, "many", tmp_path_factory.mktemp("dp"), payload)
    return dict(ranks=ranks, sd=sd, steps=steps, pre=pre, metrics=metrics,
                final=final, one_step=one_step)


def _assert_ranks_equal(a, b, path="result"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_ranks_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_ranks_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_both_ranks_hold_the_same_results(two_ranks):
    """Replicated state and all-gathered outputs: rank 1's results are rank
    0's bit for bit."""
    r0, r1 = two_ranks["ranks"]
    _assert_ranks_equal(r0, r1)


def test_dp_train_steps_match_satae_dp_step(two_ranks):
    """Two ranks from satae's weights with satae's draws against satae's
    data-parallel step on a 2-device mesh: per-step losses rtol 1e-5, the
    state after 3 steps at tests/test_torch_port_train.py's tolerance (the
    biases feeding a train-mode BatchNorm move by noise, _PreBNBiases)."""
    ours = two_ranks["ranks"][0]["satae_steps"]
    model = SupervisedAE(TCFG, 3, IMG)
    pre_t, pre_j = (_PreBNBiases(model, JCFG.bn_momentum) for _ in "tj")
    for s in range(STEPS):
        pre_t.record(ours["pre"][s])
        pre_j.record(two_ranks["pre"][s])
        for name in ("loss", "mse", "ce"):
            np.testing.assert_allclose(
                ours["metrics"][s][name], two_ranks["metrics"][s][name],
                rtol=1e-5, err_msg=f"{name} step {s}")
        assert ours["metrics"][s]["acc"] == two_ranks["metrics"][s]["acc"]
    model.load_state_dict(ours["final"])
    _assert_state_close(model, two_ranks["final"], pre_t, pre_j)


def test_dp_train_step_matches_the_one_process_step(two_ranks):
    """One step on two ranks against the port's step on the whole global
    batch in one process, from the same weights and generator seed (each
    rank draws the global batch's augmentation and keeps its rows): loss
    rtol 1e-5, BatchNorm running stats 1e-5 (global-batch moments, not per
    rank), parameters 2.1e-3 (tests/test_parallel.py)."""
    ours = two_ranks["ranks"][0]["own_steps"]
    model = SupervisedAE(TCFG, 3, IMG)
    model.load_state_dict(two_ranks["sd"])
    opt = adam_init(list(model.parameters()))
    (imgs, labels, _), = two_ranks["one_step"]
    m, _ = ae_train_step(model, opt, imgs, labels, ALPHA, 1e-3, TDATA,
                         generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ours["metrics"][0]["loss"], float(m["loss"]),
                               rtol=1e-5)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(ours["final"][k], v)
            continue
        tol = 1e-5 if k.endswith(("running_mean", "running_var")) else 2.1e-3
        np.testing.assert_allclose(ours["final"][k].numpy(), v.numpy(),
                                   atol=tol, rtol=0, err_msg=k)


def _eval_model(sd):
    model = SupervisedAE(TCFG, 3, IMG)
    model.load_state_dict(sd)
    return model


def _assert_eval_close(got, want):
    assert set(got) == {"loss", "mse", "ce", "acc"} == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_dp_eval_step_at_world_size_one(two_ranks, fresh):
    """The unweighted DP eval over a group of one rank against the
    one-process eval step on the same weights and batch (phase 26's
    1e-5)."""
    model = _eval_model(two_ranks["sd"])
    imgs, labels = _t(_u8(GB, 50)), _t(np.arange(GB) % 10)
    got = make_dp_ae_eval_step(make_mesh(1, device="cpu"))(
        model, imgs, labels, ALPHA)
    _assert_eval_close(got, ae_eval_step(model, imgs, labels, ALPHA))


def test_dp_eval_step_on_two_ranks(two_ranks):
    """Two ranks of 8 rows: the global batch's means, as the one-process
    eval step on the whole batch and as satae's unweighted DP eval on a
    2-device mesh (tests/test_parallel.py's test_dp_eval_and_encode_match,
    rtol 1e-5)."""
    ours = two_ranks["ranks"][0]["eval"]
    model = _eval_model(two_ranks["sd"])
    imgs, labels = _u8(GB, 50), np.arange(GB, dtype=np.int32) % 10
    _assert_eval_close(ours, ae_eval_step(model, _t(imgs),
                                          _t(labels).long(), ALPHA))
    mesh = jax_make_mesh(2)
    x, y = jax_shard_batch(mesh, imgs, labels)
    params, state = convert.sae_from_torch_state_dict(
        {k: v.numpy() for k, v in two_ranks["sd"].items()}, TCFG,
        image_size=IMG)
    _assert_eval_close(ours, jax_dp_eval(mesh, JCFG)(
        params, state, x, y, jnp.float32(ALPHA)))


def test_dp_eval_extraction_and_serving_match_satae(two_ranks, serving_run):
    """13 and 21 images over 2 ranks against satae's mesh functions on 2
    devices: the weighted eval's sums (a zero-weight padding row) rtol 1e-5,
    latents atol 1e-4, predictions equal, probabilities 1e-5, decoded and
    reconstructed images 1e-5 (tests/test_torch_port_decode.py's float32
    bound)."""
    ours = two_ranks["ranks"][0]["serving"]
    mesh = jax_make_mesh(2)
    jcfg = JC.PipelineConfig(data=JC.DataConfig(image_size=IMG, batch_size=8),
                             model=JCFG, runtime=JC.RuntimeConfig(n_devices=2))
    jp = JaxPipeline(jcfg).load(str(serving_run))
    imgs, labels = _u8(13, 40), np.arange(13, dtype=np.int32) % 10
    pad = np.zeros((1, IMG, IMG, 3), np.uint8)
    x, y, w = jax_shard_batch(mesh, np.concatenate([imgs, pad]),
                              np.concatenate([labels, [0]]).astype(np.int32),
                              np.r_[np.ones(13), 0.0].astype(np.float32))
    ref = jax_dp_eval_weighted(mesh, JCFG)(jp.ae_params, jp.ae_bn_state, x, y,
                                           w, jnp.float32(ALPHA))
    assert set(ours["eval"]) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours["eval"][k], float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    assert ours["eval"]["n"] == 13.0
    ex = _u8(21, 41)
    X, yx = jax_extract(jp.ae_params["encoder"], jp.ae_bn_state["encoder"],
                        JaxArrayDataset(ex, np.arange(21, dtype=np.int32) % 10),
                        JCFG, 8, jax_dp_encode_step(mesh, JCFG),
                        pad_multiple=2)
    np.testing.assert_allclose(ours["extract"][0], X, atol=1e-4)
    np.testing.assert_array_equal(ours["extract"][1], yx)
    np.testing.assert_allclose(ours["encode"], jp.encode(imgs), atol=1e-4)
    np.testing.assert_array_equal(ours["predict"], jp.predict(imgs))
    np.testing.assert_allclose(ours["proba"], jp.predict_proba(imgs),
                               atol=1e-5)
    np.testing.assert_allclose(ours["decode"], jp.decode(ours["encode"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours["reconstruct"], jp.reconstruct(imgs),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("trainer", ["scan", "steps"])
def test_dp_trainers_match_one_process(two_ranks, scan_splits, trainer):
    """The DP scan-epoch trainer (fast_loop) and the DP per-batch trainer
    (loop, its 16-image remainder batch divides over 2) on two ranks against
    the same trainer in one process, in tests/test_parallel.py's
    test_dp_scan_epoch_matches_single_device setup: best val loss and the
    train-loss curve rel 1e-3, the same epochs."""
    ours = two_ranks["ranks"][0]["trainers"][trainer]
    module = fast_loop if trainer == "scan" else loop
    ref = module.train_supervised_ae(
        scan_splits.train, scan_splits.val, model_cfg=SCAN_T,
        data_cfg=SCAN_DATA, alpha=35.0, lr=2e-3, device=CPU, max_epochs=2,
        patience=15, seed=0)
    assert ours["epochs_run"] == ref.epochs_run == 2
    assert ours["best_epoch"] == ref.best_epoch
    assert ours["best_val_loss"] == pytest.approx(ref.best_val_loss, rel=1e-3)
    np.testing.assert_allclose(ours["history"]["train_loss"],
                               ref.history["train_loss"], rtol=1e-3)
