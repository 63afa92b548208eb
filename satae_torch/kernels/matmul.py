"""Fused matmul: out = act((x @ w) * scale + shift), kernel K1 forward and
backward, each beside its plain version.

Counterpart of satae/kernels/matmul.py: ``fused_matmul`` with its custom VJP
(``_fwd``/``_bwd``, matmul.py:95-121) and ``linear_pallas``, which is the same
function with scale 1 and shift = bias. On a CUDA tensor :func:`fused_matmul`
launches the hand-written Hopper kernel ``fused_gemm``
(satae_torch/csrc/fused_gemm.cu) and is differentiable through
:func:`fused_matmul_bwd`, whose products are K1 launches too; on a CPU tensor
the same autograd function computes :func:`fused_matmul_plain` and
:func:`fused_matmul_bwd_plain`. There is no fallback from one to the other: a
kernel that fails to build or launch raises.

W reaches the product as a row-major (K, N) buffer, or with ``w_nk=True`` as
the (N, K) buffer an ``nn.Linear`` stores; K1 reads either layout, and each
backward product, in place (its ``trans_a``/``trans_b`` flags), so no
transposed copy of an operand is ever made.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from satae_torch.kernels import _build

ACTS = ("none", "relu", "sigmoid")

Grads = Tuple[Optional[torch.Tensor], ...]


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    return y


def fused_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """The plain PyTorch version of K1: float32 product and epilogue, output
    in x's dtype. ``w`` is (K, N); pass ``w.t()`` for an (N, K) weight."""
    y = (x.float() @ w.float()) * scale.float() + shift.float()
    return apply_act(y, act).to(x.dtype)


def _act_grad(g: torch.Tensor, y: torch.Tensor, act: str) -> torch.Tensor:
    """The cotangent through the activation, from its output y."""
    if act == "relu":
        return g * (y > 0).to(g.dtype)
    if act == "sigmoid":
        return g * y * (1.0 - y)
    return g


def fused_matmul_bwd_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                           scale: torch.Tensor, y: torch.Tensor,
                           act: str = "none",
                           needs: Sequence[bool] = (True, True, True, True),
                           w_nk: bool = False) -> Grads:
    """satae's ``_bwd`` (matmul.py:100-118) in plain PyTorch ops: the
    gradients (dx, dw, dscale, dshift) of act((x @ W) * scale + shift) for
    the cotangent g of its output y, W = w or w.T (``w_nk``). dw comes in
    w's own layout; an entry whose ``needs`` flag is False is None."""
    g = _act_grad(g, y, act)
    gs = g * scale
    w_kn = w.t() if w_nk else w
    dx = gs @ w_kn.t() if needs[0] else None
    dw = None
    if needs[1]:
        dw = gs.t() @ x if w_nk else x.t() @ gs
    # dscale needs the pre-epilogue product z = x @ W, recomputed
    dscale = (g * (x @ w_kn)).sum(0) if needs[2] else None
    dshift = g.sum(0) if needs[3] else None
    return dx, dw, dscale, dshift


def fused_gemm(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, act: str = "none", trans_a: bool = False,
               trans_b: bool = False) -> torch.Tensor:
    """One launch of K1 on CUDA tensors: act((A @ B) * scale + shift) with
    A = x, or x read in place as its transpose (``trans_a``: x is a (K, M)
    buffer), and B = w, or w read in place as its transpose (``trans_b``: w
    is an (N, K) buffer). Raises on a refused launch. The callers on the
    training and serving paths count the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_gemm: K1 runs on CUDA tensors, x is on "
                         f"{x.device}")
    m, k = (x.shape[1], x.shape[0]) if trans_a else x.shape
    n, kw = (w.shape[0], w.shape[1]) if trans_b else (w.shape[1], w.shape[0])
    if k != kw:
        raise ValueError(f"fused_gemm: inner sizes {k} and {kw} differ")
    _build.check_operands("fused_gemm", x.device, x=x, w=w, scale=scale,
                          shift=shift)
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError(f"fused_gemm: shape {(m, k, n)} exceeds int32 "
                         "indexing")
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    lib = _build.load("fused_gemm")
    ptrs = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), m, n, k, ACTS.index(act))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if trans_a or trans_b:
            rc = lib.satae_fused_gemm_t(*ptrs, int(trans_a), int(trans_b),
                                        stream)
        else:
            rc = lib.satae_fused_gemm(*ptrs, stream)
    _build.check(lib, rc, "fused_gemm")
    return out


def fused_matmul_bwd(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     scale: torch.Tensor, y: torch.Tensor, act: str = "none",
                     needs: Sequence[bool] = (True, True, True, True),
                     w_nk: bool = False) -> Grads:
    """The backward of :func:`fused_matmul`, step by step as satae's
    ``_bwd``: g through the activation, gs = g * scale, then dx = gs @ W^T
    and dw = x^T @ gs (or gs^T @ x for an (N, K) weight) as one K1 launch
    each, and z = x @ W recomputed on K1 for dscale only when ``needs[2]``.
    The activation gradient, the scale product and the column sums stay
    PyTorch ops, as they stay XLA ops outside the Pallas kernel in satae.

    A CUDA x launches K1 (``fused_matmul_bwd.launches`` counts the
    launches); a CPU x takes :func:`fused_matmul_bwd_plain`."""
    if x.device.type == "cpu":
        return fused_matmul_bwd_plain(g, x, w, scale, y, act, needs, w_nk)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_bwd: no kernel for device {x.device}")
    g = _act_grad(g, y, act)
    gs = (g * scale).contiguous()  # a fresh tensor: contiguous() copies nothing
    k = w.shape[1] if w_nk else w.shape[0]
    n = g.shape[1]

    def product(a, b, size, trans_a, trans_b):  # scale 1, shift 0, no act
        out = fused_gemm(a, b, x.new_ones(size), x.new_zeros(size), "none",
                         trans_a, trans_b)
        fused_matmul_bwd.launches += 1
        return out

    dx = dw = dscale = None
    if needs[0]:  # dx (M, K) = gs @ W^T; an (N, K) weight is that B as it is
        dx = product(gs, w, k, False, not w_nk)
    if needs[1]:  # dw (N, K) = gs^T @ x, or dw (K, N) = x^T @ gs
        dw = product(gs, x, k, True, False) if w_nk else \
            product(x, gs, n, True, False)
    if needs[2]:
        dscale = (g * product(x, w, n, False, w_nk)).sum(0)
    dshift = g.sum(0) if needs[3] else None
    return dx, dw, dscale, dshift


fused_matmul_bwd.launches = 0


def _forward(x, w, scale, shift, act, w_nk):
    if x.device.type == "cuda":
        y = fused_gemm(x, w, scale, shift, act, False, w_nk)
        fused_matmul.launches += 1
        return y
    return fused_matmul_plain(x, w.t() if w_nk else w, scale, shift, act)


class _FusedMatmul(torch.autograd.Function):
    """K1 (or its plain version) with satae's VJP as the backward."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, act, w_nk):
        y = _forward(x, w, scale, shift, act, w_nk)
        ctx.save_for_backward(x, w, scale, y)
        ctx.act, ctx.w_nk = act, w_nk
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, y = ctx.saved_tensors
        grads = fused_matmul_bwd(g, x, w, scale, y, ctx.act,
                                 ctx.needs_input_grad[:4], ctx.w_nk)
        return (*grads, None, None)


def fused_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, act: str = "none", *,
                 w_nk: bool = False) -> torch.Tensor:
    """act((x @ W) * scale + shift) for x (M, K), per-column scale/shift
    (N,), and W = w, a row-major (K, N) weight, or W = w.T for an (N, K)
    weight with ``w_nk=True`` (an ``nn.Linear`` weight, read in place).
    Differentiable in x, w, scale and shift (:func:`fused_matmul_bwd`).

    A CUDA x launches K1 (``fused_matmul.launches`` counts the forward
    launches); a CPU x takes :func:`fused_matmul_plain`."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[int(w_nk)]:
        raise ValueError(f"fused_matmul: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}{' (N, K)' if w_nk else ''}")
    n = w.shape[1 - int(w_nk)]
    if scale.shape != (n,) or shift.shape != (n,):
        raise ValueError(f"fused_matmul: scale/shift must be ({n},), got "
                         f"{tuple(scale.shape)}, {tuple(shift.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_matmul: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, shift)):
        return _FusedMatmul.apply(x, w, scale, shift, act, w_nk)
    # nothing to differentiate (serving): skip the autograd node's host cost
    return _forward(x, w, scale, shift, act, w_nk)


fused_matmul.launches = 0
