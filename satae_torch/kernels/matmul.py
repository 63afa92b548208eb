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

Operands are float32, or bf16 as in satae's bf16 recipe: x and w of one
dtype (a mixed pair raises; the callers cast, as satae's layers do), scale
and shift float32, the product accumulated and the epilogue taken in
float32, the output in x's dtype, rounded once (``_mm_kernel``'s
``preferred_element_type=jnp.float32`` and ``out_ref.dtype``). The backward
runs in the cotangent's dtype as satae's ``_bwd`` does: the activation's
gradient and ``g * scale`` in bf16, dX and dW as bf16 K1 launches, dscale
and dshift in float32. Each wrapper's ``launches`` counts its launches per
instantiation, keyed by the launcher suffix ("" float32, "_bf16" bf16;
``satae_torch.kernels.launch_counts`` names them ``fused_gemm_bf16`` and so
on), so a count shows which instantiation ran.
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


def fused_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       scale: Optional[torch.Tensor], shift: torch.Tensor,
                       act: str = "none") -> torch.Tensor:
    """The plain PyTorch version of K1: float32 product (of the bf16 values,
    exact in float32, for bf16 operands) and epilogue, output in x's dtype,
    rounded once. ``w`` is (K, N); pass ``w.t()`` for an (N, K) weight. A
    scale of None is 1."""
    y = x.float() @ w.float()
    if scale is not None:
        y = y * scale.float()
    return apply_act(y + shift.float(), act).to(x.dtype)


def _act_grad(g: torch.Tensor, y: torch.Tensor, act: str) -> torch.Tensor:
    """The cotangent through the activation, from its output y, in g's
    dtype."""
    if act == "relu":
        return g * (y > 0).to(g.dtype)
    if act == "sigmoid":
        return g * y * (1.0 - y)
    return g


def _mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as K1 computes it with scale 1 and shift 0: a float32 product,
    rounded once to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def fused_matmul_bwd_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                           scale: Optional[torch.Tensor], y: torch.Tensor,
                           act: str = "none",
                           needs: Sequence[bool] = (True, True, True, True),
                           w_nk: bool = False) -> Grads:
    """satae's ``_bwd`` (matmul.py:100-118) in plain PyTorch ops: the
    gradients (dx, dw, dscale, dshift) of act((x @ W) * scale + shift) for
    the cotangent g of its output y, W = w or w.T (``w_nk``). dx and dw come
    in g's dtype, dw in w's own layout, dscale and dshift in float32; an
    entry whose ``needs`` flag is False is None. A scale of None is 1 and
    has no gradient."""
    g = _act_grad(g, y, act)
    gs = g if scale is None else g * scale.to(g.dtype)
    w_kn = w.t() if w_nk else w
    dx = _mm_plain(gs, w_kn.t()) if needs[0] else None
    dw = None
    if needs[1]:
        dw = _mm_plain(gs.t(), x) if w_nk else _mm_plain(x.t(), gs)
    # dscale needs the pre-epilogue product z = x @ W, recomputed
    dscale = (g * _mm_plain(x, w_kn)).sum(0).float() if needs[2] else None
    dshift = g.sum(0).float() if needs[3] else None
    return dx, dw, dscale, dshift


# K1's tiling (satae_torch/csrc/gemm_tile.cuh): 64-row tiles, K staged 32
# deep; a split keeps >= 128 of K (4 slices) and the grid aims at about one
# wave of blocks on a 132-SM card.
TILE_M = 64
BK = 32
MIN_SPLIT_K = 128
WAVE_BLOCKS = 128


def tile_n_for(n: int) -> int:
    """The N tile of K1 and K2: 32 columns when N fits, else 64."""
    return 32 if n <= 32 else 64


def split_k_plan(m: int, n: int, k: int) -> Tuple[int, int, int, int]:
    """K1's plan for an (m, k) @ (k, n) product: (tile_m, tile_n, splits,
    k_per_split). Split s covers K range [s * k_per_split, min(k, (s + 1) *
    k_per_split)); every k_per_split is a multiple of BK. With the output's
    tiles alone at WAVE_BLOCKS or more, or k below 2 * MIN_SPLIT_K, there is
    one split; otherwise as many as reach about WAVE_BLOCKS blocks while
    each keeps at least MIN_SPLIT_K of K, on 32-wide tiles: one block sums
    each tile's S partials, at a rate one SM can read, so narrower tiles
    halve that block's bytes (`chip_smoke.py --split-sweep`)."""
    tile_n = tile_n_for(n)
    tiles = -(-m // TILE_M) * -(-n // tile_n)
    if tiles < WAVE_BLOCKS and k >= 2 * MIN_SPLIT_K:
        tile_n = 32
        tiles = -(-m // TILE_M) * -(-n // tile_n)
    splits = min(-(-WAVE_BLOCKS // max(tiles, 1)), k // MIN_SPLIT_K)
    if splits <= 1:
        return TILE_M, tile_n, 1, max(-(-k // BK), 1) * BK
    per_split = -(-k // splits)
    k_per_split = -(-per_split // BK) * BK
    return TILE_M, tile_n, -(-k // k_per_split), k_per_split


def split_k_workspace(m: int, n: int, splits: int,
                      device) -> Optional[torch.Tensor]:
    """The float32 partials of a split-K launch (of float32 or bf16
    operands), splits * m * n of them; None for one split."""
    if splits == 1:
        return None
    return torch.empty(splits * m * n, device=device, dtype=torch.float32)


# one int32 counter per output tile of a split-K launch, per device; a
# split-K plan has fewer than WAVE_BLOCKS tiles, and the kernel leaves every
# counter at 0
_counters = {}


def _tile_counters(device: torch.device) -> torch.Tensor:
    c = _counters.get(device)
    if c is None:
        c = _counters[device] = torch.zeros(WAVE_BLOCKS, dtype=torch.int32,
                                            device=device)
    return c


def fused_gemm(x: torch.Tensor, w: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None, act: str = "none",
               trans_a: bool = False, trans_b: bool = False) -> torch.Tensor:
    """One launch of K1 on CUDA tensors: act((A @ B) * scale + shift) with
    A = x, or x read in place as its transpose (``trans_a``: x is a (K, M)
    buffer), and B = w, or w read in place as its transpose (``trans_b``: w
    is an (N, K) buffer), in x's dtype: float32, or bf16 for a bf16 pair
    (its own instantiation, ``satae_fused_gemm_bf16``). A scale or shift of
    None is 1 or 0, and nothing is allocated for it. The plan is
    :func:`split_k_plan`'s; a split-K launch takes a workspace of splits * M
    * N floats. Raises on a refused launch. The callers on the training and
    serving paths count the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_gemm: K1 runs on CUDA tensors, x is on "
                         f"{x.device}")
    m, k = (x.shape[1], x.shape[0]) if trans_a else x.shape
    n, kw = (w.shape[0], w.shape[1]) if trans_b else (w.shape[1], w.shape[0])
    if k != kw:
        raise ValueError(f"fused_gemm: inner sizes {k} and {kw} differ")
    suffix = _build.check_operands("fused_gemm", x.device, x, w,
                                   scale=scale, shift=shift)
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError(f"fused_gemm: shape {(m, k, n)} exceeds int32 "
                         "indexing")
    if any(t is not None and t.shape != (n,) for t in (scale, shift)):
        raise ValueError(f"fused_gemm: scale/shift must be ({n},)")
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    if m == 0 or n == 0:
        return out
    _, tile_n, splits, k_per_split = split_k_plan(m, n, k)
    ws = split_k_workspace(m, n, splits, x.device)
    counters = None if ws is None else _tile_counters(x.device)
    _build.launch(_build.load("fused_gemm"), "satae_fused_gemm" + suffix,
                  x.device,
                  x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(shift),
                  out.data_ptr(), _ptr(ws), _ptr(counters), m, n, k,
                  ACTS.index(act), int(trans_a), int(trans_b), tile_n, splits,
                  k_per_split)
    return out


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel in ``dtype``'s instantiation."""
    wrapper.launches[_build.OPERAND_DTYPES[dtype]] += 1


def fused_matmul_bwd(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     scale: Optional[torch.Tensor], y: torch.Tensor,
                     act: str = "none",
                     needs: Sequence[bool] = (True, True, True, True),
                     w_nk: bool = False) -> Grads:
    """The backward of :func:`fused_matmul`, step by step as satae's
    ``_bwd``: g through the activation, gs = g * scale, then dx = gs @ W^T
    and dw = x^T @ gs (or gs^T @ x for an (N, K) weight) as one K1 launch
    each, and z = x @ W recomputed on K1 for dscale only when ``needs[2]``.
    The activation gradient, the scale product and the column sums stay
    PyTorch ops, as they stay XLA ops outside the Pallas kernel in satae;
    all but the float32 column sums run in g's dtype.

    A CUDA x launches K1 (counted in ``fused_matmul_bwd.launches``); a CPU
    x takes :func:`fused_matmul_bwd_plain`."""
    if x.device.type == "cpu":
        return fused_matmul_bwd_plain(g, x, w, scale, y, act, needs, w_nk)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_bwd: no kernel for device {x.device}")
    g = _act_grad(g, y, act)
    gs = (g if scale is None else g * scale.to(g.dtype)).contiguous()

    def product(a, b, trans_a, trans_b):  # scale 1, shift 0, no act
        out = fused_gemm(a, b, None, None, "none", trans_a, trans_b)
        count_launch(fused_matmul_bwd, a.dtype)
        return out

    dx = dw = dscale = None
    if needs[0]:  # dx (M, K) = gs @ W^T; an (N, K) weight is that B as it is
        dx = product(gs, w, False, not w_nk)
    if needs[1]:  # dw (N, K) = gs^T @ x, or dw (K, N) = x^T @ gs
        dw = product(gs, x, True, False) if w_nk else \
            product(x, gs, True, False)
    if needs[2]:
        dscale = (g * product(x, w, False, w_nk)).sum(0).float()
    dshift = g.sum(0).float() if needs[3] else None
    return dx, dw, dscale, dshift


fused_matmul_bwd.launches = _build.launch_counter()


def _forward(x, w, scale, shift, act, w_nk):
    if x.device.type == "cuda":
        y = fused_gemm(x, w, scale, shift, act, False, w_nk)
        count_launch(fused_matmul, x.dtype)
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


def fused_matmul(x: torch.Tensor, w: torch.Tensor,
                 scale: Optional[torch.Tensor], shift: torch.Tensor,
                 act: str = "none", *, w_nk: bool = False) -> torch.Tensor:
    """act((x @ W) * scale + shift) for x (M, K), per-column scale/shift
    (N,), and W = w, a row-major (K, N) weight, or W = w.T for an (N, K)
    weight with ``w_nk=True`` (an ``nn.Linear`` weight, read in place).
    A scale of None is 1 (a linear layer: nothing is allocated for it).
    x and w are both float32 or both bf16, scale and shift float32; the
    output is in x's dtype. Differentiable in x, w, scale and shift
    (:func:`fused_matmul_bwd`).

    A CUDA x launches K1 (counted in ``fused_matmul.launches``); a CPU x
    takes :func:`fused_matmul_plain`."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[int(w_nk)]:
        raise ValueError(f"fused_matmul: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}{' (N, K)' if w_nk else ''}")
    n = w.shape[1 - int(w_nk)]
    if (scale is not None and scale.shape != (n,)) or shift.shape != (n,):
        raise ValueError(f"fused_matmul: scale/shift must be ({n},), got "
                         f"{None if scale is None else tuple(scale.shape)}, "
                         f"{tuple(shift.shape)}")
    if x.device.type == "cpu":  # a CUDA x is checked where K1 launches
        _build.check_dtypes("fused_matmul", x, w, scale, shift)
    elif x.device.type != "cuda":
        raise ValueError(f"fused_matmul: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, scale, shift)):
        return _FusedMatmul.apply(x, w, scale, shift, act, w_nk)
    # nothing to differentiate (serving): skip the autograd node's host cost
    return _forward(x, w, scale, shift, act, w_nk)


fused_matmul.launches = _build.launch_counter()
