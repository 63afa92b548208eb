"""The port's kernel module functions against satae's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels K1/K2 are held against those same plain versions on the card by
chip_smoke.py). satae's Pallas kernel runs in interpret mode, as in
tests/test_kernels.py. Inputs come from numpy and reach both packages as the
same arrays.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satae.kernels.matmul as KM
from satae.kernels.conv import bn_fold as jax_bn_fold
from satae.kernels.conv import conv2d_bn_act_infer
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch.kernels import conv as TC
from satae_torch.kernels import launch_counts
from satae_torch.kernels import matmul as TM


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Force interpret mode for pallas_call on the CPU test platform."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _matmul_case(shape, act):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k + n)
    x, w = (rng.normal(size=s).astype(np.float32) for s in ((m, k), (k, n)))
    scale, shift = (rng.normal(size=(n,)).astype(np.float32) for _ in "ab")
    ref = KM.fused_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                          jnp.asarray(shift), act)
    out = TM.fused_matmul(_t(x), _t(w), _t(scale), _t(shift), act)
    return np.asarray(ref), out.numpy(), dict(rtol=1e-5, atol=1e-4)


def _conv_case(act):
    rng = np.random.default_rng(2)
    cin, cout = 3, 8
    x = rng.uniform(0, 1, (4, 16, 16, cin)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, cin, cout)).astype(np.float32)  # HWIO
    b = rng.normal(0, 0.3, cout).astype(np.float32)
    bn_p = {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
            "bias": rng.normal(0, 0.3, cout).astype(np.float32)}
    bn_s = {"mean": rng.normal(0, 0.3, cout).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    j_scale, j_shift = jax_bn_fold(bn_p, bn_s)
    ref = conv2d_bn_act_infer(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              j_scale, j_shift, stride=2, padding=1, act=act)
    scale, shift = TC.bn_fold(_t(bn_p["scale"]), _t(bn_p["bias"]),
                              _t(bn_s["mean"]), _t(bn_s["var"]))
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale), rtol=1e-6)
    np.testing.assert_allclose(shift.numpy(), np.asarray(j_shift), rtol=1e-6,
                               atol=1e-7)
    # the port's packing from the PyTorch OIHW layout lands on satae's HWIO
    w_hwio = TC.pack_conv_weight(_t(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(w_hwio.numpy(), w)
    out = TC.conv2d_bn_act(_t(x), w_hwio, scale, shift + _t(b) * scale,
                           stride=2, padding=1, act=act)
    return np.asarray(ref), out.numpy(), dict(rtol=1e-4, atol=1e-4)


_ACTS = ("none", "relu", "sigmoid")
_CASES = ([pytest.param("matmul", (s, a), id=f"matmul-{s}-{a}")
           for s in [(64, 4096, 64), (64, 64, 128), (7, 33, 10), (1, 64, 10)]
           for a in _ACTS]
          + [pytest.param("conv", (a,), id=f"conv-{a}") for a in _ACTS])


@pytest.mark.parametrize("kind,args", _CASES)
def test_plain_kernel_matches_pallas(kind, args):
    ref, out, tol = (_matmul_case if kind == "matmul" else _conv_case)(*args)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **tol)


def test_wrappers_validate_and_count_only_kernel_launches():
    x, w = torch.zeros(4, 3), torch.zeros(3, 2)
    one, zero = torch.ones(2), torch.zeros(2)
    with pytest.raises(ValueError, match="act"):
        TM.fused_matmul(x, w, one, zero, "tanh")
    with pytest.raises(ValueError, match="shapes"):
        TM.fused_matmul(x, torch.zeros(4, 2), one, zero)
    with pytest.raises(ValueError, match="scale/shift"):
        TM.fused_matmul(x, w, torch.ones(3), zero)
    with pytest.raises(ValueError, match="shapes"):
        TC.conv2d_bn_act(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 2, 2),
                         one, zero)
    before = launch_counts()
    TM.fused_matmul(x, w, one, zero, "relu")
    TC.conv2d_bn_act(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 2), one,
                     zero, stride=2, padding=1)
    # the CPU path is the plain version: no kernel launched, none counted
    assert launch_counts() == before
