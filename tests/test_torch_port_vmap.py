"""The config-batched (vmap) sweep engine of the port against satae's
(satae/train/vmap_sweep.py), at the tiny config of
tests/test_torch_port_train.py (channels (4, 8), latent 8, head 16, MLP
(16, 8), 16x16 images, batch 8).

  * the batched K1's plain version, forward and backward, against the
    unbatched plain K1 slice by slice, and its launch plan;
  * stacked AE and MLP steps (3 configs) against ``jax.vmap`` of satae's
    step bodies, from satae's vmapped init carried across, with satae's
    per-config draws injected;
  * ``ae_vmap_grid_search`` / ``mlp_vmap_grid_search`` against satae's on
    scripted per-config per-epoch metrics: selection, early stops, curves,
    logs and the run directory, byte for byte;
  * a real 2-epoch sweep against the port's single-config training of each
    config from the same init, batch order and draws.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from satae import config as JC
from satae.io.torch_export import (mlp_to_torch_state_dict,
                                   sae_to_torch_state_dict)
from satae.models.mlp import mlp_init
from satae.models.supervised_ae import supervised_ae_init
from satae.train import hbm as jhbm
from satae.train import vmap_sweep as jvmap
from satae.train.optim import adam_init as jax_adam_init
from satae.train.steps import ae_train_step_body, make_mlp_train_step
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.io import convert
from satae_torch.kernels import _build
from satae_torch.kernels import matmul as TM
from satae_torch.models.mlp import MLP
from satae_torch.models.stacked import StackedMLP, StackedSupervisedAE
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn import stacked as TS
from satae_torch.nn.init import init_
from satae_torch.train import fast_loop, hbm, optim
from satae_torch.train import steps as tsteps
from satae_torch.train import vmap_sweep as tvmap
from satae_torch.train.steps import (ae_train_step, mlp_train_step,
                                     stacked_ae_train_step,
                                     stacked_mlp_train_step)
from test_torch_port_grid import _assert_same_run_dir, _assert_same_winner
from test_torch_port_models import numpy_trees
from test_torch_port_train import (_PreBNBiases, _assert_state_close,
                                   _satae_aug_draws, _t, _u8)

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, B, C = 16, 8, 3
JDATA = JC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
TDATA = TC.DataConfig(per_class=8, image_size=IMG, batch_size=B)
ALPHAS, LRS = (20.0, 35.0, 50.0), (1e-3, 5e-3, 2e-3)
NAN = float("nan")
CPU = torch.device("cpu")
# XLA's cheapest compile for satae's reference programs: the same
# operations, compiled in a few seconds instead of tens on a busy host
FAST = dict(xla_backend_optimization_level=0,
            xla_llvm_disable_expensive_passes=True)


def _sae_sd(p, s):
    return sae_to_torch_state_dict(p, s, JCFG, image_size=IMG)


def _mlp_sd(p, s):
    return mlp_to_torch_state_dict(p, s, JCFG)


def _slice(tree, i):
    return jax.tree_util.tree_map(lambda a: np.asarray(a[i]), tree)


def _stack(trees):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


@pytest.fixture(scope="module")
def splits():
    return make_splits(load_dataset(TDATA), TDATA)


# -- (a) the batched K1's plain version and plan ------------------------------

@pytest.mark.parametrize("w_nk", [False, True])
@pytest.mark.parametrize("act", TM.ACTS)
@pytest.mark.parametrize("with_scale", [False, True])
def test_batched_plain_k1_equals_unbatched_per_slice(w_nk, act, with_scale):
    """Forward and backward (autograd through K1's Function on a config
    axis) against the 2-D plain K1 on each config's slices: bit for bit,
    since the plain version computes slice by slice."""
    rng = np.random.default_rng(0)
    c, m, k, n = 4, 7, 33, 10
    x = rng.normal(size=(c, m, k)).astype(np.float32)
    w = rng.normal(size=(c, n, k) if w_nk else (c, k, n)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (c, n)).astype(np.float32) \
        if with_scale else None
    shift = rng.normal(size=(c, n)).astype(np.float32)
    g = rng.normal(size=(c, m, n)).astype(np.float32)
    leaves = [None if a is None else _t(a).requires_grad_()
              for a in (x, w, scale, shift)]
    y = TM.fused_matmul(*leaves, act, w_nk=w_nk)
    grads = torch.autograd.grad(y, [t for t in leaves if t is not None],
                                _t(g))
    for i in range(c):
        one = [None if a is None else _t(a[i]).requires_grad_()
               for a in (x, w, scale, shift)]
        yi = TM.fused_matmul(*one, act, w_nk=w_nk)
        gi = torch.autograd.grad(yi, [t for t in one if t is not None],
                                 _t(g[i]))
        assert torch.equal(y[i], yi)
        for a, b in zip(grads, gi):
            assert torch.equal(a[i], b)
    # the backward's plain version on its own, every gradient asked for
    bwd = TM.fused_matmul_bwd(_t(g), _t(x), _t(w),
                              None if scale is None else _t(scale),
                              y.detach(), act, w_nk=w_nk)
    for i in range(c):
        ref = TM.fused_matmul_bwd_plain(_t(g[i]), _t(x[i]), _t(w[i]),
                                        None if scale is None
                                        else _t(scale[i]), y[i].detach(),
                                        act, w_nk=w_nk)
        for a, b in zip(bwd, ref):
            assert torch.equal(a[i], b)


def test_batched_k1_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TM.fused_gemm(x, torch.zeros(2, 8, 3))
    with pytest.raises(ValueError, match="bad shapes"):
        TM.fused_matmul(x, torch.zeros(3, 8, 5), None, torch.zeros(3, 5))
    with pytest.raises(ValueError, match="scale/shift"):
        TM.fused_matmul(x, torch.zeros(2, 5, 8), None, torch.zeros(5),
                        w_nk=True)
    with pytest.raises(TypeError):
        TM.fused_matmul(x, torch.zeros(2, 8, 5, dtype=torch.bfloat16), None,
                        torch.zeros(2, 5))
    # K1's launchers, every one over a config axis (2-D products are C =
    # 1): on the mma.sync loop seven pointers, then C, M, N, K, act,
    # trans_a, trans_b, tile_n, splits, k_per_split; on wgmma (buffers TMA
    # reads) x, w, scale, shift, out, then C, M, N, K, act, trans_a,
    # trans_b, splits, k_per_split
    launchers = _build.LAUNCHERS["fused_gemm"]
    assert len(launchers) == 4
    for sfx in ("", "_bf16"):
        assert launchers["satae_fused_gemm_batched" + sfx] == (7, 10)
        assert launchers["satae_fused_gemm_batched" + sfx + "_tma"] == (5, 9)
    # a bf16 stack with a 20-byte row is not refused: it takes the
    # mma.sync loop, and only on the card
    with pytest.raises(ValueError, match="CUDA"):
        TM.fused_gemm(torch.zeros(2, 4, 10, dtype=torch.bfloat16),
                      torch.zeros(2, 10, 8, dtype=torch.bfloat16))


# the batched K1's plans on the vmap path (C = 45 AE configs, 11 MLP lrs):
# (m, k, n, C) -> (tile_m, tile_n, splits, k_per_split)
_BATCHED = {
    (64, 4096, 64, 45): (64, 32, 2, 2048),  # projection fwd, dec_in dX
    (64, 64, 4096, 45): (64, 64, 1, 64),  # dec_in fwd, projection dX, dW
    (4096, 64, 64, 45): (64, 64, 1, 64),  # dec_in dW
    (128, 64, 64, 45): (64, 64, 1, 64),  # head fc1 dW
    (64, 64, 128, 45): (64, 64, 1, 64),  # head fc1 fwd
    (64, 128, 10, 45): (64, 32, 1, 128),  # head fc2 fwd
    (64, 64, 128, 11): (64, 64, 1, 64),  # MLP fc0 fwd
    (64, 128, 64, 11): (64, 64, 1, 128),  # MLP fc1 fwd
    (64, 64, 10, 11): (64, 32, 1, 64),  # MLP fc2 fwd
    (64, 4096, 64, 1): (64, 32, 32, 128),  # C = 1: the unbatched plan
}


@pytest.mark.parametrize("shape", list(_BATCHED),
                         ids=[f"C{c}_{m}x{k}x{n}" for m, k, n, c in _BATCHED])
def test_batched_plan_at_vmap_path_shapes(shape):
    m, k, n, c = shape
    assert TM.split_k_plan(m, n, k, batch=c) == _BATCHED[shape]
    if c == 1:
        assert TM.split_k_plan(m, n, k) == _BATCHED[shape]


@settings(max_examples=200, deadline=None)
@given(c=st.integers(1, 64), m=st.integers(1, 5000), n=st.integers(1, 2000),
       k=st.integers(1, 8000))
def test_batched_plan_covers_k_once_per_config(c, m, n, k):
    """Every config's K is covered once, in order; the grid's z (C *
    splits) stays within CUDA's limit; the workspace holds C * splits
    planes of M * N floats; the tile counters fit the per-device buffer."""
    tile_m, tile_n, splits, kps = TM.split_k_plan(m, n, k, batch=c)
    assert tile_n in (32, 64) and kps % TM.BK == 0
    assert splits == 1 or (splits - 1) * kps < k <= splits * kps
    assert c * splits <= 65535
    tiles = -(-m // tile_m) * -(-n // tile_n)
    if c * -(-m // tile_m) * -(-n // TM.tile_n_for(n)) >= TM.WAVE_BLOCKS:
        assert splits == 1
    if splits > 1:
        assert kps >= TM.MIN_SPLIT_K and c * tiles < TM.WAVE_BLOCKS
        ws = TM.split_k_workspace(c * m, n, splits, "meta")
        assert ws.numel() == c * splits * m * n
    # never more splits than one config's plan takes
    assert splits <= TM.split_k_plan(m, n, k)[2]


# the batched K1's plans on the bf16 wgmma route at every launch of the
# stacked steps (C = 45 AE configs, 11 MLP lrs; fc2's dX and dW take the
# mma.sync loop): (m, k, n, C) -> (tile_m, tile_n, splits, k_per_split)
_BATCHED_TMA = {
    (64, 4096, 64, 45): (64, 64, 4, 1024),  # projection fwd, dec_in dX
    (64, 64, 4096, 45): (64, 64, 1, 64),  # dec_in fwd, projection dX, dW
    (4096, 64, 64, 45): (64, 64, 1, 64),  # dec_in dW
    (64, 64, 128, 45): (64, 64, 1, 64),  # head fc1 fwd
    (64, 128, 64, 45): (64, 64, 1, 128),  # head fc1 dX
    (128, 64, 64, 45): (64, 64, 1, 64),  # head fc1 dW
    (64, 128, 10, 45): (64, 64, 1, 128),  # head fc2 fwd
    (64, 64, 128, 11): (64, 64, 1, 64),  # MLP fc0 fwd, fc1 dX, dW
    (64, 128, 64, 11): (64, 64, 1, 128),  # MLP fc0 dX, fc1 fwd
    (128, 64, 64, 11): (64, 64, 1, 64),  # MLP fc0 dW
    (64, 64, 10, 11): (64, 64, 1, 64),  # MLP fc2 fwd
    (64, 4096, 64, 1): (64, 64, 16, 256),  # C = 1: the unbatched plan
}


@pytest.mark.parametrize("shape", list(_BATCHED_TMA),
                         ids=[f"C{c}_{m}x{k}x{n}"
                              for m, k, n, c in _BATCHED_TMA])
def test_batched_tma_plan_at_vmap_path_shapes(shape):
    m, k, n, c = shape
    assert TM.split_k_plan_tma(m, n, k, batch=c) == _BATCHED_TMA[shape]
    if c == 1:
        assert TM.split_k_plan_tma(m, n, k) == _BATCHED_TMA[shape]


@settings(max_examples=200, deadline=None)
@given(c=st.integers(1, 64), m=st.integers(1, 5000), n=st.integers(1, 2000),
       k=st.integers(1, 8000))
def test_batched_tma_plan_covers_k_once_per_config(c, m, n, k):
    """On the wgmma route every config's K is covered once, in order, in
    splits of whole 64-deep stages; a tile's splits fit one cluster; the
    grid's z (C * splits) stays within CUDA's limit; never more splits than
    one config's plan."""
    tile_m, tile_n, splits, kps = TM.split_k_plan_tma(m, n, k, batch=c)
    assert (tile_m, tile_n) == (64, 64) and kps % TM.TMA_BK == 0
    assert 1 <= splits <= TM.MAX_CLUSTER
    ranges = [(s * kps, min(k, (s + 1) * kps)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert c * splits <= 65535
    assert splits <= TM.split_k_plan_tma(m, n, k)[2]
    wave = TM.TMA_WAVE_BLOCKS if c == 1 else TM.TMA_WAVE_BLOCKS_BATCHED
    if c * -(-m // 64) * -(-n // 64) >= wave or k < 2 * TM.TMA_MIN_SPLIT_K:
        assert splits == 1
    if splits > 1:
        assert kps >= TM.TMA_MIN_SPLIT_K


# -- (b) stacked steps against jax.vmap of satae's step bodies ---------------

def test_stacked_ae_train_steps_match_vmapped_satae():
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    vparams, vbn = jax.jit(jax.vmap(lambda k: supervised_ae_init(
        k, JCFG, image_size=IMG)), compiler_options=FAST)(keys)
    model = StackedSupervisedAE(TCFG, C, 3, IMG)
    model.load_state_dict(convert.to_tensors(
        convert.stacked_to_torch_state_dict(vparams, vbn, _sae_sd)))
    vopt = jax_adam_init(vparams)
    vopt["step"] = jnp.zeros((C,), jnp.int32)
    opt = optim.adam_init(list(model.parameters()))
    step = jax.jit(jax.vmap(ae_train_step_body(JCFG, JDATA),
                            in_axes=(0, 0, 0, None, None, 0, 0, 0)),
                   compiler_options=FAST)
    single = SupervisedAE(TCFG, 3, IMG)
    pre_t = [_PreBNBiases(single, JCFG.bn_momentum) for _ in range(C)]
    pre_j = [_PreBNBiases(single, JCFG.bn_momentum) for _ in range(C)]
    alphas, lrs = np.float32(ALPHAS), np.float32(LRS)
    rng = np.random.default_rng(0)
    for s in range(5):
        for i in range(C):
            pre_t[i].record(model.config(i))
            pre_j[i].record(_sae_sd(_slice(vparams, i), _slice(vbn, i)))
        imgs, labels = _u8(B, seed=10 + s), rng.integers(0, 10, B)
        ks = jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, s)
        vparams, vbn, vopt, m_j = step(
            vparams, vbn, vopt, jnp.asarray(imgs),
            jnp.asarray(labels, jnp.int32), ks, jnp.asarray(alphas),
            jnp.asarray(lrs))
        draws = [_satae_aug_draws(ks[i], B) for i in range(C)]
        m_t, grads = stacked_ae_train_step(
            model, opt, _t(imgs), _t(labels), _t(alphas), _t(lrs), TDATA,
            **{k: torch.stack([d[k] for d in draws]) for k in draws[0]})
        assert len(grads) == len(list(model.parameters()))
        for name in ("loss", "mse", "ce"):
            np.testing.assert_allclose(m_t[name].numpy(),
                                       np.asarray(m_j[name]), rtol=1e-5,
                                       err_msg=f"{name} step {s}")
        np.testing.assert_array_equal(m_t["acc"].numpy(),
                                      np.asarray(m_j["acc"]))
    for i in range(C):
        single.load_state_dict(model.config(i))
        _assert_state_close(single, _sae_sd(_slice(vparams, i),
                                            _slice(vbn, i)),
                            pre_t[i], pre_j[i])


def test_stacked_mlp_train_steps_match_vmapped_satae():
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    vparams, vbn = jax.jit(jax.vmap(lambda k: mlp_init(k, JCFG)),
                           compiler_options=FAST)(keys)
    model = StackedMLP(TCFG, C)
    model.load_state_dict(convert.to_tensors(
        convert.stacked_to_torch_state_dict(vparams, vbn, _mlp_sd)))
    vopt = jax_adam_init(vparams)
    vopt["step"] = jnp.zeros((C,), jnp.int32)
    opt = optim.adam_init(list(model.parameters()))
    step = jax.vmap(make_mlp_train_step(JCFG, donate=False),
                    in_axes=(0, 0, 0, None, None, 0, 0, None))
    single = MLP(TCFG)
    pre_t = [_PreBNBiases(single, JCFG.bn_momentum) for _ in range(C)]
    pre_j = [_PreBNBiases(single, JCFG.bn_momentum) for _ in range(C)]
    lrs, wd = np.float32(LRS), 1e-4
    rng = np.random.default_rng(1)
    for s in range(5):
        for i in range(C):
            pre_t[i].record(model.config(i))
            pre_j[i].record(_mlp_sd(_slice(vparams, i), _slice(vbn, i)))
        x = rng.normal(size=(B, JCFG.latent_dim)).astype(np.float32)
        labels = rng.integers(0, 10, B)
        ks = jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, s)
        vparams, vbn, vopt, m_j = step(
            vparams, vbn, vopt, jnp.asarray(x),
            jnp.asarray(labels, jnp.int32), ks, jnp.asarray(lrs),
            jnp.float32(wd))
        mask = torch.stack([_t(jax.random.bernoulli(
            ks[i], 1 - JCFG.mlp_dropout, (B, JCFG.mlp_hidden[0])))
            for i in range(C)])
        m_t, _ = stacked_mlp_train_step(model, opt, _t(x), _t(labels),
                                        _t(lrs), wd, dropout_mask=mask)
        np.testing.assert_allclose(m_t["loss"].numpy(),
                                   np.asarray(m_j["loss"]), rtol=1e-5,
                                   err_msg=f"step {s}")
        np.testing.assert_array_equal(m_t["acc"].numpy(),
                                      np.asarray(m_j["acc"]))
    for i in range(C):
        single.load_state_dict(model.config(i))
        _assert_state_close(single, _mlp_sd(_slice(vparams, i),
                                            _slice(vbn, i)),
                            pre_t[i], pre_j[i])


@pytest.mark.parametrize("lr", [1, np.float32(1e-2), torch.tensor(1e-2)],
                         ids=["int", "np_float32", "scalar_tensor"])
def test_adam_update_takes_any_real_lr(lr):
    """An int, numpy or 0-d tensor lr steps as the Python float of it."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(3, 4)).astype(np.float32)
    grads = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2)]
    ref, got = _t(p0), _t(p0)
    s_ref, s_got = optim.adam_init([ref]), optim.adam_init([got])
    for g in grads:
        optim.adam_update([ref], [_t(g)], s_ref, float(lr), 1e-2)
        optim.adam_update([got], [_t(g)], s_got, lr, 1e-2)
        assert type(got) is torch.Tensor and torch.equal(got, ref)


def test_stacked_models_carry_satae_trees_both_ways():
    """satae's vmapped trees -> stacked state_dict -> config(i) equals the
    single-config carry-over of slice i; and back to the trees exactly."""
    vparams, vbn = _stack([numpy_trees(supervised_ae_init, JCFG,
                                       image_size=IMG, seed=s)
                           for s in range(C)])
    model = StackedSupervisedAE(TCFG, C, 3, IMG)
    model.load_state_dict(convert.to_tensors(
        convert.stacked_to_torch_state_dict(vparams, vbn, _sae_sd)))
    for i in range(C):
        want = _sae_sd(_slice(vparams, i), _slice(vbn, i))
        got = model.config(i)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    back = convert.stacked_from_torch_state_dict(
        model.state_dict(), lambda sd: convert.sae_from_torch_state_dict(
            sd, TCFG, 3, IMG))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, (vparams, vbn))
    # the per-config init is the sequential engine's of seed + i
    model.init_configs(7)
    for i in range(C):
        single = init_(SupervisedAE(TCFG, 3, IMG),
                       torch.Generator().manual_seed(7 + i))
        for k, v in single.state_dict().items():
            assert torch.equal(model.config(i)[k], v), k


# -- (c) the sweeps' selection and bookkeeping against satae's ----------------

class _Jax:
    """satae's vmap_sweep's ``jax`` with jit and vmap passing the scripted
    bodies through (marked ``scripted``), everything else jax's own."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(f, **kw):
        return f if getattr(f, "scripted", False) else jax.jit(f, **kw)

    @staticmethod
    def vmap(f, **kw):
        return f if getattr(f, "scripted", False) else jax.jit(
            jax.vmap(f, **kw), compiler_options=FAST)


def _scripted(f):
    f.scripted = True
    return f


def _epoch_trees(kind, n_epochs, n_cfg):
    """Distinct stacked satae trees per epoch (numpy)."""
    init = (lambda s: numpy_trees(supervised_ae_init, JCFG, image_size=IMG,
                                  seed=s)) if kind == "ae" else \
        (lambda s: numpy_trees(mlp_init, JCFG, seed=s))
    return [_stack([init(100 * e + i) for i in range(n_cfg)])
            for e in range(n_epochs)]


def _script(monkeypatch, kind, val, n_val=12.0):
    """Replace both packages' epoch and eval bodies by the same script:
    epoch e leaves the weights ``_epoch_trees``[e] and per-config val
    metric ``val[e]`` (loss for the AE, accuracy for the MLP), with train
    sums and the other val metric derived from it."""
    val = np.asarray(val, np.float32)
    n_epochs, n_cfg = val.shape
    trees = _epoch_trees(kind, n_epochs, n_cfg)
    one = _sae_sd if kind == "ae" else _mlp_sd
    sds = [convert.to_tensors(convert.stacked_to_torch_state_dict(*t, one))
           for t in trees]
    keys = ("loss", "mse", "ce", "acc") if kind == "ae" else ("loss", "acc")
    train = lambda e: {k: np.float32(56.0 * (1 + j) + e) *
                       np.ones(n_cfg, np.float32) + np.arange(n_cfg,
                                                              dtype=np.float32)
                       for j, k in enumerate(keys)}

    def vsum(e):
        other = np.float32(0.25) + np.arange(n_cfg, dtype=np.float32) / 8
        if kind == "ae":
            loss, acc = val[e], other
            out = {"loss": loss * n_val, "mse": loss * n_val / 4,
                   "ce": loss * n_val / 2, "acc": acc * n_val}
        else:
            out = {"loss": (other + 1) * n_val, "acc": val[e] * n_val}
        return {k: v.astype(np.float32) for k, v in out.items()}

    state = {"j": 0, "t": 0, "jv": 0, "tv": 0}
    single_eval = jax.jit(jhbm.mlp_eval_body(JCFG), compiler_options=FAST)

    @_scripted
    def j_epoch(params, bn, opt, *args):
        e = state["j"]
        state["j"] += 1
        return (*trees[e], opt, train(e))

    @_scripted
    def j_eval(params, bn, *args):
        leaf = jax.tree_util.tree_leaves(params)[0]
        if np.ndim(leaf) == np.ndim(jax.tree_util.tree_leaves(
                _slice(trees[0][0], 0))[0]):  # a single MLP: the real eval
            return single_eval(params, bn, *args)
        e = state["jv"]
        state["jv"] += 1
        return {**vsum(e), "n": np.full(n_cfg, n_val, np.float32)}

    def t_epoch(model, *args):
        e = state["t"]
        state["t"] += 1
        model.load_state_dict(sds[e])
        return {k: torch.from_numpy(v) for k, v in train(e).items()}

    def t_eval(model, *args):
        e = state["tv"]
        state["tv"] += 1
        return {**{k: torch.from_numpy(v) for k, v in vsum(e).items()},
                "n": torch.tensor(n_val)}

    monkeypatch.setattr(jvmap, "jax", _Jax())
    # satae's init is overwritten by the first scripted epoch: numpy trees
    # of its shapes stand in (an initialiser compiled per case costs seconds)
    name, init = ("supervised_ae_init", supervised_ae_init) if kind == "ae" \
        else ("mlp_init", mlp_init)
    shapes = numpy_trees(init, JCFG, **({"image_size": IMG}
                                        if kind == "ae" else {}))
    monkeypatch.setattr(jvmap, name, lambda *a, **k: shapes)
    if kind == "ae":
        monkeypatch.setattr(jhbm, "ae_train_epoch_body",
                            lambda *a, **k: j_epoch)
        monkeypatch.setattr(jhbm, "ae_eval_body", lambda *a, **k: j_eval)
        monkeypatch.setattr(hbm, "stacked_ae_train_epoch", t_epoch)
        monkeypatch.setattr(hbm, "stacked_ae_eval_sums", t_eval)
    else:
        monkeypatch.setattr(jhbm, "mlp_train_epoch_body",
                            lambda *a, **k: j_epoch)
        monkeypatch.setattr(jhbm, "mlp_eval_body", lambda *a, **k: j_eval)
        monkeypatch.setattr(hbm, "stacked_mlp_train_epoch", t_epoch)
        monkeypatch.setattr(hbm, "stacked_mlp_eval_sums", t_eval)


AE_VMAP_CASES = {
    # per epoch, per config val loss; patience 2
    # config 1 wins at epoch 0 and stops at epoch 2: its lower losses after
    # that do not count
    "staggered_stops": [[1.0, 0.5, 3.0, 1.5], [0.9, 0.6, 3.1, 1.4],
                        [0.95, 0.7, 2.9, 1.3], [0.8, 0.4, 3.0, 1.35],
                        [0.85, 0.3, 3.2, 1.36], [0.86, 0.2, 3.3, 1.2]],
    "global_best_moves": [[1.0, 1.1, 1.2, 1.3], [0.9, 0.8, 1.2, 1.25],
                          [0.95, 0.85, 0.7, 1.2], [0.99, 0.9, 0.75, 0.6]],
    "all_nan": [[NAN] * 4, [NAN] * 4, [NAN] * 4],
    "nan_config_beside_finite": [[NAN, 1.0, 2.0, NAN], [NAN, 1.1, 1.9, NAN],
                                 [NAN, 0.9, 2.5, NAN]],
}
MLP_VMAP_CASES = {
    "best_moves_between_lrs": [[0.5, 0.4, 0.3], [0.45, 0.6, 0.35],
                               [0.7, 0.55, 0.65]],
    "first_lr_wins_ties": [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
    "one_lr_never_improves": [[0.5, NAN, 0.2], [0.6, NAN, 0.1]],
}


def _run_vmap_both(kind, val, tmp_path, monkeypatch, splits, **extra):
    _script(monkeypatch, kind, val)
    n_epochs, n_cfg = np.shape(val)
    runs = {p: tmp_path / p for p in ("satae", "port")}
    for r in runs.values():
        r.mkdir()
    jlog, tlog = [], []
    if kind == "ae":
        grid = dict(alphas=(20.0, 35.0), learning_rates=(1e-3, 5e-3),
                    max_epochs=n_epochs, patience=2)
        j = jvmap.ae_vmap_grid_search(
            splits.train, splits.val, model_cfg=JCFG, data_cfg=JDATA,
            ae_cfg=JC.AETrainConfig(**grid), seed=3,
            out_dir=str(runs["satae"]), log=jlog.append)
        t = tvmap.ae_vmap_grid_search(
            splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
            ae_cfg=TC.AETrainConfig(**grid), device=CPU, seed=3,
            out_dir=str(runs["port"]), log=tlog.append)
    else:
        rng = np.random.default_rng(0)
        x = {n: rng.standard_normal((n, 8)).astype(np.float32)
             for n in (56, 12)}
        y = {n: rng.integers(0, 10, n).astype(np.int32) for n in (56, 12)}
        lrs = (1e-3, 1e-2, 1e-4)[:n_cfg]
        kw = dict(batch_size=B, seed=3, test_x=x[12][::-1].copy(),
                  test_y=y[12][::-1].copy())
        j = jvmap.mlp_vmap_grid_search(
            x[56], y[56], x[12], y[12], model_cfg=JCFG,
            mlp_cfg=JC.MLPTrainConfig(learning_rates=lrs, epochs=n_epochs),
            out_dir=str(runs["satae"]), log=jlog.append, **kw)
        t = tvmap.mlp_vmap_grid_search(
            x[56], y[56], x[12], y[12], model_cfg=TCFG,
            mlp_cfg=TC.MLPTrainConfig(learning_rates=lrs, epochs=n_epochs),
            device=CPU, out_dir=str(runs["port"]), log=tlog.append, **kw)
    assert t.best_hparams == j.best_hparams
    assert tlog == jlog
    assert json.dumps(t.results, sort_keys=True) == json.dumps(
        j.results, sort_keys=True)
    _assert_same_winner(kind, j.best, t.best)
    assert t.best.epochs_run == j.best.epochs_run
    assert json.dumps(t.best.history) == json.dumps(j.best.history)
    _assert_same_run_dir(runs["satae"], runs["port"])
    return j, t


@pytest.mark.parametrize("case", sorted(AE_VMAP_CASES))
def test_ae_vmap_sweep_selects_as_satae(case, tmp_path, monkeypatch, splits):
    val = AE_VMAP_CASES[case]
    _, t = _run_vmap_both("ae", val, tmp_path, monkeypatch, splits)
    runs = [r["epochs_run"] for r in t.results.values()]
    if case == "staggered_stops":
        # each config stops two epochs after its last lower loss (patience
        # 2); the winner's curves end at its own stop
        assert runs == [6, 3, 5, 5]
        assert t.best_hparams == {"alpha": 20.0, "lr": 5e-3}
        assert t.best.best_epoch == 0 and t.best.epochs_run == 6
        assert len(t.best.history["val_loss"]) == 3
    if case == "all_nan":
        meta = json.loads((tmp_path / "port" / "ae_global_best.json")
                          .read_text())
        assert meta["diverged"] is True and t.best_hparams == {
            "alpha": 20.0, "lr": 1e-3}
        assert runs == [2, 2, 2, 2]
    if case == "global_best_moves":
        assert t.best_hparams == {"alpha": 35.0, "lr": 5e-3}
        assert t.best.best_epoch == 3


@pytest.mark.parametrize("case", sorted(MLP_VMAP_CASES))
def test_mlp_vmap_sweep_selects_as_satae(case, tmp_path, monkeypatch,
                                         splits):
    _, t = _run_vmap_both("mlp", MLP_VMAP_CASES[case], tmp_path, monkeypatch,
                          splits)
    tested = [("test_acc" in r) for r in t.results.values()]
    if case == "one_lr_never_improves":
        assert tested == [True, False, True]
    else:
        assert all(tested)


# -- (d) a real sweep against each config's single-config training ------------

def _recorder(monkeypatch, module, name):
    """Wrap ``module.name`` to record what it returns."""
    real, seen = getattr(module, name), []

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out
    monkeypatch.setattr(module, name, wrapped)
    return seen


def _close(a, b, what):
    assert math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-6), (what, a, b)


def test_ae_vmap_sweep_equals_each_configs_single_training(monkeypatch,
                                                           splits):
    """At lrs of 1e-5 and 2e-5. The biases that feed a train-mode BatchNorm
    have an exact gradient of zero, so each run's is rounding noise of its
    own summation order (grouped or not), and Adam moves them by about lr
    a step in its sign; through the running means that reaches the val
    loss (3.5e-5 relative at lr 1e-3 after 14 steps). Those biases and the
    running means they feed are left out of the weights held here."""
    draws = _recorder(monkeypatch, tsteps, "draw_stacked_augmentation")
    grid = TC.AETrainConfig(alphas=(20.0, 35.0), learning_rates=(1e-5, 2e-5),
                            max_epochs=2)
    sweep = tvmap.ae_vmap_grid_search(
        splits.train, splits.val, model_cfg=TCFG, data_cfg=TDATA,
        ae_cfg=grid, device=CPU, seed=5)
    images, labels, vi, vl, vw = fast_loop.upload_ae_data(
        splits.train, splits.val, B, CPU)
    hps = [(a, lr) for a in grid.alphas for lr in grid.learning_rates]
    steps = len(splits.train) // B
    assert len(draws) == grid.max_epochs * steps
    for i, (alpha, lr) in enumerate(hps):
        model = init_(SupervisedAE(TCFG, 3, IMG),
                      torch.Generator().manual_seed(5 + i))
        opt = optim.adam_init(list(model.parameters()))
        losses, snaps = [], []
        for epoch in range(grid.max_epochs):
            order = hbm.epoch_order(len(splits.train), B, 5, epoch)
            for s, idx in enumerate(torch.from_numpy(order)):
                flip, offsets, noise = draws[epoch * steps + s]
                ae_train_step(model, opt, images[idx], labels[idx], alpha,
                              lr, TDATA, flip=flip[i], offsets=offsets[i],
                              noise=noise[i])
            sums = hbm.ae_eval_sums(model, vi, vl, vw, alpha)
            losses.append(float(sums["loss"] / sums["n"]))
            snaps.append({k: v.clone() for k, v in model.state_dict().items()})
        rec = sweep.results[json.dumps({"alpha": alpha, "lr": lr})]
        best = int(np.argmin(losses))
        assert rec["best_epoch"] == best and rec["epochs_run"] == 2
        _close(rec["best_val_loss"], losses[best], f"config {i}")
        if sweep.best_hparams == {"alpha": alpha, "lr": lr}:
            noise = {n for b, bn in _PreBNBiases(model, 0.1).pairs
                     for n in (b, bn + ".running_mean")}
            for k, v in snaps[best].items():
                if k in noise:
                    continue
                np.testing.assert_allclose(
                    sweep.best.state_dict()[k].numpy(), v.numpy(),
                    rtol=1e-5, atol=1e-5, err_msg=k)


def test_mlp_vmap_sweep_equals_each_lrs_single_training(monkeypatch):
    masks = _recorder(monkeypatch, TS, "keep_mask")
    rng = np.random.default_rng(2)
    xtr = rng.standard_normal((40, 8)).astype(np.float32)
    ytr = rng.integers(0, 10, 40).astype(np.int32)
    xva = rng.standard_normal((12, 8)).astype(np.float32)
    yva = rng.integers(0, 10, 12).astype(np.int32)
    mcfg = TC.MLPTrainConfig(learning_rates=(1e-3, 1e-2), epochs=2)
    sweep = tvmap.mlp_vmap_grid_search(xtr, ytr, xva, yva, model_cfg=TCFG,
                                       mlp_cfg=mcfg, device=CPU,
                                       batch_size=B, seed=4)
    xs, ys, vx, vy, vw = fast_loop.upload_mlp_data(xtr, ytr, xva, yva, B, CPU)
    steps = len(ytr) // B
    for i, lr in enumerate(mcfg.learning_rates):
        model = init_(MLP(TCFG), torch.Generator().manual_seed(4 + i))
        opt = optim.adam_init(list(model.parameters()))
        accs = []
        for epoch in range(mcfg.epochs):
            order = hbm.epoch_order(len(ytr), B, 4, epoch)
            for s, idx in enumerate(torch.from_numpy(order)):
                mlp_train_step(model, opt, xs[idx], ys[idx], lr,
                               mcfg.weight_decay,
                               dropout_mask=masks[epoch * steps + s][i])
            sums = hbm.mlp_eval_sums(model, vx, vy, vw)
            accs.append(float(sums["acc"] / sums["n"]))
        rec = sweep.results[json.dumps({"lr": lr})]
        _close(rec["best_val_acc"], max(accs), f"lr {lr}")
        assert rec["best_epoch"] == int(np.argmax(accs))
