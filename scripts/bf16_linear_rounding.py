"""Where the port's bf16 ``linear`` parts from satae's, and whether it
matters to a train step. CPU only, JAX's CPU backend and the port's plain
kernel versions.

satae's training ``linear`` rounds the bf16 product and then the bias add
(satae/nn/layers.py:258-261). The port's runs K1, which adds the bias in
float32 and rounds once (satae_torch.nn.layers.linear); its
``linear_plain`` rounds twice, as satae does.

* Layer: a 64x128x64 bf16 product (inputs, weights and biases from a numpy
  seed, PyTorch's default weight scale): the share of outputs that differ
  from satae's, and the largest difference in bf16 ulps of the larger
  addend (the product or the bias), for ``linear`` and ``linear_plain``.
* Step: tests/test_torch_port_bf16.py::test_bf16_ae_steps_match_satae's 5
  bf16 AE steps against satae's step body, once with the port's ``linear``
  and once with ``linear_plain`` handed to ``ae_train_step``: each step's
  relative loss gap, and the first step's gradient gap per tensor (relative
  L2 against satae's bf16 gradient; the test's exceptions left out).

Prints one JSON object. Usage:
  JAX_PLATFORMS=cpu python scripts/bf16_linear_rounding.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def layer_gaps(seed: int = 0) -> dict:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from satae.nn.layers import linear as jax_linear
    from satae_torch.nn import layers as L

    m, k, n = 64, 128, 64
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.uniform(-bound, bound, (n, k)).astype(np.float32)  # (out, in)
    b = rng.uniform(-bound, bound, n).astype(np.float32)
    ref = jax_linear({"w": jnp.asarray(w.T), "b": jnp.asarray(b)},
                     jnp.asarray(x, jnp.bfloat16))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    # the unit: one bf16 ulp of the larger addend (the product, rounded
    # first in satae, or the bias), where a rounding of either lands
    prod = xb.float() @ torch.from_numpy(w).to(torch.bfloat16).float().T
    big = torch.maximum(prod.abs(), torch.from_numpy(b).abs().expand_as(prod))
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    out = {"shape": [m, k, n]}
    for name, fn in (("linear", L.linear), ("linear_plain", L.linear_plain)):
        y = fn(xb, torch.from_numpy(w), torch.from_numpy(b)).float()
        out[name] = dict(differ_share=float((y != ref).float().mean()),
                         max_diff_in_ulps=float(((y - ref).abs() / ulp)
                                                .max()))
    return out


def step_gaps(linear) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_port_bf16 as T
    from satae.data.augment import augment_train_batch as jax_augment
    from satae.models.supervised_ae import (supervised_ae_apply,
                                            supervised_ae_init)
    from satae.train.losses import joint_ae_loss as jax_joint_loss
    from satae.train.optim import adam_init as jax_adam_init
    from satae.train.steps import ae_train_step_body
    from satae_torch import config as TC
    from satae_torch.io.convert import sae_to_torch_state_dict, to_tensors
    from satae_torch.models.supervised_ae import SupervisedAE
    from satae_torch.train import optim
    from satae_torch.train.steps import ae_train_step
    from satae import config as JC

    torch.set_num_threads(2)
    JCFG, TCFG, IMG, B = T.JCFG, T.TCFG, T.IMG, T.B
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
    losses, grad_gaps = [], {}
    for s in range(5):
        imgs, labels = T._u8(B, seed=10 + s), rng.integers(0, 10, B)
        k = jax.random.fold_in(key, s)
        if s == 0:
            x = jax_augment(k, jnp.asarray(imgs), dtype=jnp.bfloat16)

            def loss_fn(p):
                (x_hat, logits, _), _ = supervised_ae_apply(
                    p, state, x, train=True, cfg=JCFG)
                return jax_joint_loss(x_hat, logits, x, jnp.asarray(labels),
                                      alpha)[0]
            g16 = to_tensors(sae_to_torch_state_dict(
                jax.grad(loss_fn)(params), state, TCFG, IMG))
        params, state, opt_j, m_j = step(
            params, state, opt_j, jnp.asarray(imgs),
            jnp.asarray(labels, jnp.int32), k, jnp.float32(alpha),
            jnp.float32(lr))
        m_t, grads = ae_train_step(
            model, opt_t, torch.from_numpy(imgs), torch.from_numpy(labels),
            alpha, lr, tdata, dtype=torch.bfloat16, linear=linear,
            **T._satae_draws(k, B, jnp.bfloat16))
        losses.append(abs(float(m_t["loss"]) - float(m_j["loss"]))
                      / float(m_j["loss"]))
        if s == 0:
            skip = T._pre_bn_biases(model)
            names = {m: nm for nm, m in model.named_modules()}
            out_bias = f"{names[model.dec.blocks()[-1][0]]}.bias"
            for (name, _), g in zip(model.named_parameters(), grads):
                if name not in skip and name != out_bias:
                    ref = g16[name].float()
                    grad_gaps[name] = float((g.float() - ref).norm()
                                            / ref.norm())
    return dict(loss_rel_gaps=losses, first_step_grad_rel_l2=grad_gaps)


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from satae_torch.nn import layers as L

    out = {"layer": layer_gaps(),
           "steps": {"linear (K1, one rounding)": step_gaps(L.linear),
                     "linear_plain (two roundings)": step_gaps(
                         L.linear_plain)}}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
