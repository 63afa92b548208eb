"""The port's bf16 recipe (``RuntimeConfig.compute_dtype="bfloat16"``: bf16
compute, float32 master parameters, the MLP in float32) against satae's, on
the CPU, at tiny widths. Inputs come from numpy with a seed; satae's Pallas
kernel runs in interpret mode. On the CPU the port's kernel wrappers run
their plain versions, which are the bf16 kernels' references on the card:
a float32 product of the bf16 values, a float32 epilogue, one rounding.

Tolerances are in bf16 ulps of the reference value (one ulp of |v| is
2^(floor(log2 |v|) - 7), between 2^-8 and 2^-7 of |v|), plus 1e-6 for
values near zero, where the two float32 sums' own rounding shows.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satae.kernels.matmul as KM
from satae import config as JC
from satae.api import SatAEPipeline as JaxPipeline
from satae.data.augment import augment_train_batch as jax_augment
from satae.kernels.conv import conv2d_bn_act_infer
from satae.models.supervised_ae import (supervised_ae_apply,
                                        supervised_ae_init)
from satae.train.losses import joint_ae_loss as jax_joint_loss
from satae.train.optim import adam_init as jax_adam_init
from satae.train.steps import ae_train_step_body
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.api import SatAEPipeline
from satae_torch.data.ingest import load_dataset
from satae_torch.data.pipeline import make_splits
from satae_torch.io.convert import sae_to_torch_state_dict, to_tensors
from satae_torch.kernels import conv as TK
from satae_torch.kernels import matmul as TM
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.nn import layers as TL
from satae_torch.train import optim
from satae_torch.train.steps import ae_train_step

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Force interpret mode for pallas_call on the CPU test platform."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ref (8 significant bits); 0 at 0."""
    r = ref.float().abs()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return torch.where(r > 0, ulp, torch.zeros_like(r))


def assert_ulps(out, ref, ulps: int = 1, min_equal: float = 0.99,
                what: str = "") -> None:
    """out within ``ulps`` bf16 ulps of ref (+ 1e-6) everywhere, and at
    least ``min_equal`` of the values bit-equal."""
    out, ref = torch.as_tensor(np.asarray(out, np.float32)), \
        torch.as_tensor(np.asarray(ref, np.float32))
    assert out.shape == ref.shape, what
    err = (out - ref).abs()
    bound = ulps * bf16_ulp(ref) + 1e-6
    assert bool((err <= bound).all()), (
        f"{what}: {int((err > bound).sum())} values beyond {ulps} ulp, max "
        f"{float((err / bound).max()):.3g} x the bound")
    equal = float((out == ref).float().mean())
    assert equal >= min_equal, f"{what}: {equal:.4f} bit-equal"


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (to nearest even), as float32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _k1_case(shape, seed=0):
    m, k, n = shape
    rng = np.random.default_rng(seed + m * 1000 + k + n)
    x = _bf16(rng.normal(size=(m, k)))
    w = _bf16(rng.uniform(-1, 1, size=(k, n)) / k ** 0.5)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    return x, w, scale, shift


def _jb(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tb(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


# ---- K1 and K2 ----------------------------------------------------------

_K1 = [(64, 4096, 64), (7, 33, 10), (1, 64, 10)]


@pytest.mark.parametrize("act", ["none", "relu", "sigmoid"])
@pytest.mark.parametrize("shape", _K1, ids=[f"{m}x{k}x{n}" for m, k, n in _K1])
def test_k1_plain_bf16_matches_satae(shape, act):
    """fused_matmul_plain on bf16 operands against satae's fused_matmul in
    bf16: both sum the exact products in float32 and round once, so they
    differ only where the two sums straddle a rounding boundary. One ulp,
    >= 99 % bit-equal; the output is bf16 in both."""
    x, w, scale, shift = _k1_case(shape)
    ref = KM.fused_matmul(_jb(x), _jb(w), jnp.asarray(scale),
                          jnp.asarray(shift), act)
    assert ref.dtype == jnp.bfloat16
    out = TM.fused_matmul(_tb(x), _tb(w), torch.from_numpy(scale),
                          torch.from_numpy(shift), act)
    assert out.dtype == BF16
    assert_ulps(out.float(), np.asarray(ref.astype(jnp.float32)),
                what=f"K1 {shape} {act}")


@pytest.mark.parametrize("act", ["none", "relu", "sigmoid"])
def test_k1_backward_bf16_matches_satae_vjp(act):
    """The backward in bf16 against satae's custom VJP (matmul.py:95-121)
    in bf16: dX and dW are bf16 products of bf16 operands (g through the
    activation and the scale, rounded to bf16 in both), within two ulps and
    >= 98 % bit-equal; dscale and dshift are float32 (scale's dtype) in
    both, sums of bf16 terms rounded to bf16 first, within two ulps."""
    m, k, n = 48, 96, 24
    x, w, scale, shift = _k1_case((m, k, n), seed=1)
    rng = np.random.default_rng(2)
    pre = x.astype(np.float64) @ w * scale + shift
    # no cotangent where relu's kink is a rounding away
    g = _bf16(rng.normal(size=(m, n)) * (np.abs(pre) > 1e-2))
    args = (_jb(x), _jb(w), jnp.asarray(scale), jnp.asarray(shift))
    _, vjp = jax.vjp(lambda *a: KM.fused_matmul(*a, act), *args)
    ref = vjp(_jb(g))
    leaves = [_tb(x).requires_grad_(), _tb(w).requires_grad_(),
              torch.from_numpy(scale).requires_grad_(),
              torch.from_numpy(shift).requires_grad_()]
    y = TM.fused_matmul(*leaves, act)
    y.backward(_tb(g))
    for name, leaf, r in zip(("dx", "dw", "dscale", "dshift"), leaves, ref):
        assert str(leaf.grad.dtype).split(".")[-1] == str(r.dtype), name
        assert_ulps(leaf.grad.float(), np.asarray(r.astype(jnp.float32)),
                    ulps=2, min_equal=0.98 if name in ("dx", "dw") else 0.0,
                    what=f"backward {name} {act}")


@pytest.mark.parametrize("cin", [3, 32])
def test_k2_plain_bf16_matches_satae(cin):
    """conv2d_bn_act_plain on bf16 operands against satae's
    conv2d_bn_act_infer in bf16 (im2col + the Pallas GEMM), conv bias folded
    into the shift as satae folds it: one ulp, >= 99 % bit-equal."""
    rng = np.random.default_rng(cin)
    cout = 16
    x = _bf16(rng.uniform(0, 1, (2, 12, 12, cin)))
    w = _bf16(rng.uniform(-1, 1, (3, 3, cin, cout)) / (9 * cin) ** 0.5)
    b = _bf16(rng.normal(0, 0.1, cout))
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    ref = conv2d_bn_act_infer(_jb(x), _jb(w), _jb(b), jnp.asarray(scale),
                              jnp.asarray(shift), stride=2, padding=1,
                              act="relu")
    assert ref.dtype == jnp.bfloat16
    out = TK.conv2d_bn_act(_tb(x), _tb(w), torch.from_numpy(scale),
                           torch.from_numpy(shift + b * scale), stride=2,
                           padding=1, act="relu")
    assert out.dtype == BF16
    assert_ulps(out.float(), np.asarray(ref.astype(jnp.float32)),
                what=f"K2 Cin {cin}")


def test_mixed_operand_dtypes_are_refused():
    """A bf16 x with a float32 w would promote silently in the plain
    versions: every wrapper refuses it, and a bf16 scale or shift."""
    x, w = torch.ones(4, 8, dtype=BF16), torch.ones(8, 3)
    with pytest.raises(TypeError, match="pair"):
        TM.fused_matmul(x, w, None, torch.zeros(3))
    with pytest.raises(TypeError, match="shift"):
        TM.fused_matmul(x, w.to(BF16), None, torch.zeros(3, dtype=BF16))
    with pytest.raises(TypeError, match="pair"):
        TK.conv2d_bn_act(torch.ones(1, 4, 4, 3, dtype=BF16),
                         torch.ones(3, 3, 3, 2), torch.ones(2),
                         torch.zeros(2), 2, 1, "relu")


# ---- the slice as a whole --------------------------------------------------

JCFG = JC.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                      mlp_hidden=(16, 8))
TCFG = TC.ModelConfig(**dataclasses.asdict(JCFG))
IMG, B = 16, 8
JBF16 = JC.RuntimeConfig(compute_dtype="bfloat16")
TBF16 = TC.RuntimeConfig(compute_dtype="bfloat16")


def _u8(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_bf16_pipeline_serving_matches_satae(use_pallas, tmp_path):
    """encode and predict of a bf16 pipeline against satae's in bf16, on
    satae's XLA path (layer by layer: BatchNorm in bf16, two roundings per
    linear) and on its Pallas path (the same BN fold from bf16-rounded
    parameters, one rounding per layer). Latents within 2^-6 relative L2
    of XLA's (three bf16 layers of 2^-8 rounding each, 2^-7 of Pallas's),
    predictions equal on >= 90 % of 64 random images (a tiny random model's
    logits sit close together; on the committed full-width model the two
    agree on 99 %+, test_full_test_split_matches_satae_bf16)."""
    ae_p, ae_s = supervised_ae_init(jax.random.PRNGKey(0), JCFG,
                                    image_size=IMG)
    from satae.models.mlp import mlp_init
    mlp_p, mlp_s = mlp_init(jax.random.PRNGKey(1), JCFG)
    jp = JaxPipeline(JC.PipelineConfig(
        data=JC.DataConfig(image_size=IMG, batch_size=B), model=JCFG,
        runtime=dataclasses.replace(JBF16, use_pallas=use_pallas)))
    jp.ae_params, jp.ae_bn_state, jp.mlp_params, jp.mlp_bn_state = (
        ae_p, ae_s, mlp_p, mlp_s)
    jp.save(str(tmp_path))
    tp = SatAEPipeline(TC.PipelineConfig(
        data=TC.DataConfig(image_size=IMG, batch_size=B), model=TCFG,
        runtime=TBF16), device="cpu").load(str(tmp_path))
    imgs = _u8(64, seed=5)
    z, z_ref = tp.encode(imgs), jp.encode(imgs)
    assert z.dtype == np.float32 and z.shape == z_ref.shape
    gap = np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref)
    assert gap <= (2 ** -7 if use_pallas else 2 ** -6), gap
    agree = float((tp.predict(imgs) == jp.predict(imgs)).mean())
    assert agree >= 0.9, agree
    assert all(p.dtype == torch.float32 for p in tp.ae.parameters())


def _satae_draws(key, n, dtype):
    """The flip, offsets and noise satae's augment_train_batch draws from
    ``key`` in ``dtype`` (augment.py:83-93)."""
    kf, kc, kn = jax.random.split(key, 3)
    t = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32)))
    return dict(flip=t(jax.random.bernoulli(kf, 0.5, (n, 1))).bool(),
                offsets=t(jax.random.randint(kc, (n, 2), 0, 9)).long(),
                noise=t(jax.random.normal(kn, (n, IMG, IMG, 3), dtype)))


def _pre_bn_biases(model):
    names = {m: n for n, m in model.named_modules()}
    pairs = model.enc.blocks() + [(c, bn) for c, bn in model.dec.blocks()
                                  if bn is not None]
    return {f"{names[c]}.bias" for c, _ in pairs}


def test_bf16_ae_steps_match_satae():
    """5 bf16 AE train steps at lr 1e-5 against satae's step body in bf16,
    satae's augmentation draws injected (its noise drawn in bf16). The
    parameters and Adam's moments stay float32 in both.

    Per-step loss within 1e-3 relative (measured <= 1.6e-4; the bf16
    roundings of the two frameworks fall in other places, satae's XLA
    linears rounding twice and K1 once). First-step gradients within 3e-2
    relative L2 of satae's bf16 gradient, per tensor (measured <= 0.0296 at
    this seed, the same under 1 and 3 torch threads; bf16 itself moves
    satae's gradient 0.004-0.056 from its float32 one here, and 0.1-0.35 at
    seeds 1-2, so the bound holds at this seed only). Two exceptions. The
    biases that feed a train-mode BatchNorm are left out: their exact
    gradient is zero, what either computes is rounding noise. The output
    layer's bias is a sum over every pixel, which satae's bf16 step
    accumulates in bf16 (0.41 from its own float32 gradient) and the port
    in float32: it is held within 1e-2 of satae's float32 gradient instead
    (measured 0.0012 at seeds 0-2)."""
    key = jax.random.PRNGKey(0)
    params, state = supervised_ae_init(key, JCFG, image_size=IMG)
    model = SupervisedAE(TCFG, 3, IMG)
    model.load_state_dict(to_tensors(sae_to_torch_state_dict(
        params, state, TCFG, IMG)), strict=True)
    tdata = TC.DataConfig(image_size=IMG, batch_size=B)
    lr, alpha = 1e-5, 35.0
    step = jax.jit(ae_train_step_body(
        JCFG, JC.DataConfig(image_size=IMG, batch_size=B), jnp.bfloat16))
    opt_j, opt_t = jax_adam_init(params), optim.adam_init(
        list(model.parameters()))
    rng = np.random.default_rng(0)
    for s in range(5):
        imgs, labels = _u8(B, seed=10 + s), rng.integers(0, 10, B)
        k = jax.random.fold_in(key, s)
        if s == 0:  # satae's first-step gradients in bf16 and in float32
            x = jax_augment(k, jnp.asarray(imgs), dtype=jnp.bfloat16)

            def grads_of(xx):
                def loss_fn(p):
                    (x_hat, logits, _), _ = supervised_ae_apply(
                        p, state, xx, train=True, cfg=JCFG)
                    return jax_joint_loss(x_hat, logits, xx,
                                          jnp.asarray(labels), alpha)[0]
                return to_tensors(sae_to_torch_state_dict(
                    jax.grad(loss_fn)(params), state, TCFG, IMG))
            g16, g32 = grads_of(x), grads_of(x.astype(jnp.float32))
        params, state, opt_j, m_j = step(
            params, state, opt_j, jnp.asarray(imgs),
            jnp.asarray(labels, jnp.int32), k, jnp.float32(alpha),
            jnp.float32(lr))
        m_t, grads = ae_train_step(
            model, opt_t, torch.from_numpy(imgs), torch.from_numpy(labels),
            alpha, lr, tdata, dtype=BF16, **_satae_draws(k, B, jnp.bfloat16))
        gap = abs(float(m_t["loss"]) - float(m_j["loss"])) / float(
            m_j["loss"])
        assert gap <= 1e-3, (s, gap)
        if s:
            continue
        rel = lambda a, b: float((a.float() - b.float()).norm()
                                 / b.float().norm())
        skip = _pre_bn_biases(model)
        names = {m: n for n, m in model.named_modules()}
        out_bias = f"{names[model.dec.blocks()[-1][0]]}.bias"
        for (name, prm), g in zip(model.named_parameters(), grads):
            assert g.dtype == torch.float32 == prm.dtype, name
            if name == out_bias:
                assert rel(g, g32[name]) <= 1e-2, (name, rel(g, g32[name]))
            elif name not in skip:
                assert rel(g, g16[name]) <= 3e-2, (name, rel(g, g16[name]))
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())
    assert all(m.dtype == torch.float32 for m in opt_t.mu + opt_t.nu)


def test_bf16_ae_eval_sums_match_satae():
    """The AE's selection metric in bf16 (the model in bf16, the sums in
    float32, satae's hbm.py:216-222) against satae's ``ae_eval_body`` in
    bf16, after 30 float32 steps at the fit's lr have moved the BatchNorm
    running stats: loss, MSE and CE within 1e-3 relative (measured <= 7e-5),
    accuracy equal."""
    from satae.train.hbm import ae_eval_body
    from satae_torch.train import hbm

    key = jax.random.PRNGKey(0)
    params, state = supervised_ae_init(key, JCFG, image_size=IMG)
    step = jax.jit(ae_train_step_body(
        JCFG, JC.DataConfig(image_size=IMG, batch_size=B), jnp.float32))
    opt = jax_adam_init(params)
    rng = np.random.default_rng(0)
    for s in range(30):
        params, state, opt, _ = step(
            params, state, opt, jnp.asarray(_u8(B, seed=100 + s)),
            jnp.asarray(rng.integers(0, 10, B), jnp.int32),
            jax.random.fold_in(key, s), jnp.float32(35.0), jnp.float32(5e-3))
    nb = 6
    imgs = np.stack([_u8(B, seed=500 + i) for i in range(nb)])
    labels = rng.integers(0, 10, (nb, B))
    weights = np.ones((nb, B), np.float32)
    ref = ae_eval_body(JCFG, jnp.bfloat16)(
        params, state, jnp.asarray(imgs), jnp.asarray(labels, jnp.int32),
        jnp.asarray(weights), jnp.float32(35.0))
    model = SupervisedAE(TCFG, 3, IMG)
    model.load_state_dict(to_tensors(sae_to_torch_state_dict(
        params, state, TCFG, IMG)), strict=True)
    out = hbm.ae_eval_sums(model, torch.from_numpy(imgs),
                           torch.from_numpy(labels), torch.from_numpy(weights),
                           35.0, BF16)
    assert all(v.dtype == torch.float32 for v in out.values())
    for k in ("loss", "mse", "ce"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-3)
    assert float(out["acc"]) == float(ref["acc"])
    assert float(out["n"]) == nb * B


_FIT = dict(data=dict(per_class=8, image_size=IMG, batch_size=B),
            ae=dict(alphas=(20.0, 35.0), learning_rates=(1e-3, 5e-3),
                    max_epochs=2),
            mlp=dict(learning_rates=(1e-3, 1e-2), epochs=2))


def _configs():
    t = TC.PipelineConfig(
        data=TC.DataConfig(**_FIT["data"]), model=TCFG,
        ae=TC.AETrainConfig(**_FIT["ae"]), mlp=TC.MLPTrainConfig(**_FIT["mlp"]),
        runtime=TBF16)
    j = JC.PipelineConfig(
        data=JC.DataConfig(**_FIT["data"]), model=JCFG,
        ae=JC.AETrainConfig(**_FIT["ae"]), mlp=JC.MLPTrainConfig(**_FIT["mlp"]),
        runtime=JBF16)
    return t, j


@pytest.mark.parametrize("grid", [False, True], ids=["single", "grid"])
def test_bf16_fit_writes_a_run_dir_satae_loads(grid, tmp_path):
    """A tiny bf16 fit, single-config and grid, into a run directory: the
    master parameters stay float32, and satae loads the directory, its
    trees float32, and serves it in bf16 as the port does (predictions on
    the test split equal on >= 90 %, the tiny model's logits close)."""
    tcfg, jcfg = _configs()
    pipe = SatAEPipeline(tcfg, device="cpu")
    summary = pipe.fit(grid=grid, out_dir=str(tmp_path))
    assert np.isfinite(summary.ae_val_loss) and 0 <= summary.test_acc <= 1
    for mod in (pipe.ae, pipe.mlp):
        assert all(t.dtype == torch.float32
                   for t in mod.state_dict().values() if t.is_floating_point())
    jp = JaxPipeline(jcfg).load(str(tmp_path))
    for tree in (jp.ae_params, jp.ae_bn_state, jp.mlp_params,
                 jp.mlp_bn_state):
        assert all(a.dtype == jnp.float32
                   for a in jax.tree_util.tree_leaves(tree))
    test = make_splits(load_dataset(tcfg.data), tcfg.data).test
    preds = pipe.predict(test.images)
    assert summary.test_acc == float((preds == test.labels).mean())
    assert float((preds == jp.predict(test.images)).mean()) >= 0.9


def test_throughput_config_equals_satae():
    """satae's batch-1024 recipe, field for field."""
    from satae.config import throughput_config as jax_tp
    from satae_torch.config import throughput_config as port_tp
    for batch in (1024, 512):
        ours = dataclasses.asdict(port_tp(TC.PipelineConfig(), batch))
        theirs = dataclasses.asdict(jax_tp(JC.PipelineConfig(), batch))
        for section in ("data", "model", "ae", "mlp"):
            assert ours[section] == theirs[section], section
        assert ours["data"]["batch_size"] == batch
    with pytest.raises(ValueError, match="multiple"):
        port_tp(TC.PipelineConfig(), 1000)


def test_bf16_gate_reference_is_the_recorded_gate():
    """scripts/satae_pc256_gate_bfloat16.json, the reference chip_smoke.py
    holds the port's bf16 grid against, is satae's bf16 grid fit of the
    recorded pc256 gate: the gate's configuration, every AE config and MLP
    lr stored, and the summary's winner the store's best."""
    import json
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    gate = json.loads((repo / "benchmarks" / "torch_parity_pc256" /
                       "torch_pipeline_parity.json").read_text())
    ref = json.loads((repo / "scripts" /
                      "satae_pc256_gate_bfloat16.json").read_text())
    assert ref["dtype"] == "bfloat16"
    assert ref["config"] == {k: gate[k] for k in (
        "per_class", "ae_epochs", "ae_grid", "mlp_lrs", "mlp_epochs", "seed")}
    ae = ref["stores"]["validation_losses.json"]
    assert list(ae) == [json.dumps({"alpha": a, "lr": lr})
                        for a in gate["ae_grid"]["alphas"]
                        for lr in gate["ae_grid"]["lrs"]]
    assert list(ref["stores"]["mlp_results.json"]) == [
        json.dumps({"lr": lr}) for lr in gate["mlp_lrs"]]
    best = min(ae, key=lambda k: ae[k]["best_val_loss"])
    assert json.loads(best) == ref["satae"]["ae_hparams"]
    assert ae[best]["best_val_loss"] == ref["satae"]["ae_best_val_loss"]
