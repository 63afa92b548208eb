"""The backward of the port's fused matmul against satae's custom VJP.

On the CPU the port's autograd function runs K1's plain versions,
``fused_matmul_plain`` forward and ``fused_matmul_bwd_plain`` backward (the
CUDA kernels are held against those same plain versions on the card by
chip_smoke.py). satae's ``jax.grad`` through ``fused_matmul`` runs its
Pallas kernel in interpret mode, as tests/test_kernels.py runs it. Inputs
come from numpy and reach both packages as the same arrays; the shapes are
non-square so that a transposed operand or gradient cannot pass unnoticed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satae.kernels.matmul as KM
from satae_torch.kernels import launch_counts
from satae_torch.kernels import matmul as TM

SHAPES = [(16, 32, 24), (7, 33, 10), (1, 64, 10)]
ACTS = ("none", "relu", "sigmoid")
TOL = dict(rtol=1e-4, atol=1e-3)  # satae's own, tests/test_kernels.py:64


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Force interpret mode for pallas_call on the CPU test platform."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    yield


def _inputs(shape, seed):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = rng.normal(0, 0.3, n).astype(np.float32)
    cot = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, scale, shift, cot


def _satae_grads(x, w, scale, shift, cot, act):
    def f(*args):
        return jnp.sum(KM.fused_matmul(*args, act) * cot)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, scale, shift)))]


@pytest.mark.parametrize("w_nk", [False, True], ids=["w_kn", "w_nk"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_satae_vjp(shape, act, w_nk):
    """dx, dw, dscale and dshift for a random cotangent, with W given as a
    (K, N) buffer or as the (N, K) buffer an nn.Linear stores."""
    x, w, scale, shift, cot = _inputs(shape, seed=sum(shape))
    refs = _satae_grads(x, w, scale, shift, cot, act)
    ts = [torch.from_numpy(a).requires_grad_()
          for a in (x, np.ascontiguousarray(w.T) if w_nk else w, scale,
                    shift)]
    y = TM.fused_matmul(*ts, act, w_nk=w_nk)
    y.backward(torch.from_numpy(cot))
    dw = ts[1].grad.T if w_nk else ts[1].grad
    for name, ours, ref in zip(("dx", "dw", "dscale", "dshift"),
                               (ts[0].grad, dw, ts[2].grad, ts[3].grad),
                               refs):
        assert ours.shape == ref.shape, name
        np.testing.assert_allclose(ours.numpy(), ref, err_msg=name, **TOL)


class _CountMatmuls(torch.overrides.TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("act", ACTS)
def test_constant_scale_skips_the_recompute(act, monkeypatch):
    """A linear layer's scale is a constant ones vector: no dscale, and no
    z = x @ W recompute (two products, not three), with the other gradients
    still satae's."""
    counter = _CountMatmuls()
    real = TM.fused_matmul_bwd_plain

    def counted(*args, **kwargs):  # runs on the autograd engine's thread
        with counter:
            return real(*args, **kwargs)

    monkeypatch.setattr(TM, "fused_matmul_bwd_plain", counted)
    x, w, scale, shift, cot = _inputs((7, 33, 10), seed=3)
    refs = _satae_grads(x, w, scale, shift, cot, act)
    xt, wt, tt = (torch.from_numpy(a).requires_grad_() for a in (x, w, shift))
    TM.fused_matmul(xt, wt, torch.from_numpy(scale), tt, act).backward(
        torch.from_numpy(cot))
    assert counter.n == 2
    for ours, ref in zip((xt.grad, wt.grad, tt.grad),
                         (refs[0], refs[1], refs[3])):
        np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    # and the recompute does happen when dscale is asked for
    st = torch.from_numpy(scale).requires_grad_()
    TM.fused_matmul(xt, wt, st, tt, act).backward(torch.from_numpy(cot))
    assert counter.n == 2 + 3
    np.testing.assert_allclose(st.grad.numpy(), refs[2], **TOL)


@pytest.mark.parametrize("w_nk", [False, True], ids=["w_kn", "w_nk"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_backward_matches_autograd(act, w_nk):
    """fused_matmul_bwd_plain, the reference the CUDA backward is held
    against on the card, equals autograd through fused_matmul_plain."""
    x, w, scale, shift, cot = _inputs((16, 32, 24), seed=9)
    ts = [torch.from_numpy(a).requires_grad_()
          for a in (x, np.ascontiguousarray(w.T) if w_nk else w, scale,
                    shift)]
    y = TM.fused_matmul_plain(ts[0], ts[1].t() if w_nk else ts[1], *ts[2:],
                              act)
    g = torch.from_numpy(cot)
    refs = torch.autograd.grad(y, ts, g)
    ours = TM.fused_matmul_bwd_plain(g, *(t.detach() for t in ts[:3]),
                                     y.detach(), act, w_nk=w_nk)
    for a, b in zip(ours, refs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    none = TM.fused_matmul_bwd_plain(g, *(t.detach() for t in ts[:3]),
                                     y.detach(), act,
                                     needs=(False, True, False, True),
                                     w_nk=w_nk)
    assert none[0] is None and none[2] is None


def test_cpu_backward_launches_no_kernel():
    before = launch_counts()
    x, w, scale, shift, cot = _inputs((7, 33, 10), seed=4)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    TM.fused_matmul(xt, wt, torch.from_numpy(scale), torch.from_numpy(shift),
                    "relu").backward(torch.from_numpy(cot))
    assert launch_counts() == before
    with pytest.raises(ValueError, match="shapes"):
        TM.fused_matmul(xt, wt, torch.from_numpy(scale),
                        torch.from_numpy(shift), w_nk=True)
