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

Where TMA can read both buffers (:func:`k1_loader`) K1 runs its wgmma
kernel, float32 as 3xTF32 and bf16 alike; other buffers, and the float32
shapes the mma.sync loop runs faster, take that loop. The ViT encoder's
large bf16 products run K1's wide kernel instead (:func:`k1_wide`,
satae_torch/csrc/gemm_wide.cu).

Every function here also takes operands with a leading config axis: x (C,
M, K), w (C, K, N) or (C, N, K), scale (C, N) or None, shift (C, N), out
(C, M, N). satae's config-batched sweep (satae/train/vmap_sweep.py) runs
every linear layer under ``jax.vmap``, which gives ``_mm_kernel``'s
pallas_call a batch grid axis; the port's counterpart is one K1 launch over
the C configs of a stacked linear, forward and backward, with one plan for
every config and every config's tiles counted toward the plan's wave. The
launchers of csrc/fused_gemm.cu all take C, and 2-D operands launch them
with C = 1; the wide kernel takes 2-D operands only.

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
on), so a count shows which instantiation ran; a launch over a config axis
is counted apart, in the wrapper's ``batched_launches`` (``launch_counts``'
``fused_gemm_batched`` and ``fused_gemm_batched_bwd``). Each launch is
counted by its span (:class:`launch_span`: ``satae.k1``), the one point of
instrumentation of a launch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from satae_torch.kernels import _build
from satae_torch.utils.profiling import span

# the epilogue's activations (csrc/epilogue.cuh), in its order; "gelu" is
# the exact erf form of ViT's MLP, which on the card only the wgmma kernel of
# bf16 operands computes, for A and B read as they are (gelu_ok)
ACTS = ("none", "relu", "sigmoid", "gelu")

Grads = Tuple[Optional[torch.Tensor], ...]


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "gelu":
        return torch.nn.functional.gelu(y)
    return y


def fused_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       scale: Optional[torch.Tensor], shift: torch.Tensor,
                       act: str = "none") -> torch.Tensor:
    """The plain PyTorch version of K1: float32 product (of the bf16 values,
    exact in float32, for bf16 operands) and epilogue, output in x's dtype,
    rounded once. ``w`` is (K, N); pass ``w.t()`` for an (N, K) weight. A
    scale of None is 1. A stack (C, M, K) runs each config's slices in
    turn, stacked, so each is bit for bit the 2-D version's."""
    if x.dim() == 3:
        return torch.stack([fused_matmul_plain(
            x[c], w[c], None if scale is None else scale[c], shift[c], act)
            for c in range(x.shape[0])])
    y = x.float() @ w.float()
    if scale is not None:
        y = y * scale.float()
    return apply_act(y + shift.float(), act).to(x.dtype)


def _act_grad(g: torch.Tensor, y: torch.Tensor, act: str,
              pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cotangent through the activation, in g's dtype: from its output
    y, or for "gelu", which its output does not determine, from its input
    ``pre``: GELU'(u) = Phi(u) + u * phi(u), in float32."""
    if act == "relu":
        return g * (y > 0).to(g.dtype)
    if act == "sigmoid":
        return g * y * (1.0 - y)
    if act == "gelu":
        u = pre.float()
        d = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476)) \
            + u * torch.exp(-0.5 * u * u) * 0.3989422804014327
        return (g.float() * d).to(g.dtype)
    return g


def _mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as K1 computes it with scale 1 and shift 0: a float32 product,
    rounded once to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def fused_matmul_bwd_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                           scale: Optional[torch.Tensor], y: torch.Tensor,
                           act: str = "none",
                           needs: Sequence[bool] = (True, True, True, True),
                           w_nk: bool = False, *,
                           shift: Optional[torch.Tensor] = None) -> Grads:
    """satae's ``_bwd`` (matmul.py:100-118) in plain PyTorch ops: the
    gradients (dx, dw, dscale, dshift) of act((x @ W) * scale + shift) for
    the cotangent g of its output y, W = w or w.T (``w_nk``). dx and dw come
    in g's dtype, dw in w's own layout, dscale and dshift in float32; an
    entry whose ``needs`` flag is False is None. A scale of None is 1 and
    has no gradient. For "gelu" the activation's input is recomputed from
    x, w, scale and ``shift`` (None is 0). A stack (C, M, K) runs each
    config's slices in turn, each gradient stacked over the configs."""
    if x.dim() == 3:
        per = [fused_matmul_bwd_plain(
            g[c], x[c], w[c], None if scale is None else scale[c], y[c], act,
            needs, w_nk, shift=None if shift is None else shift[c])
            for c in range(x.shape[0])]
        return tuple(None if parts[0] is None else torch.stack(parts)
                     for parts in zip(*per))
    w_kn = w.t() if w_nk else w
    pre = None
    if act == "gelu":
        pre = (x.float() @ w_kn.float())
        if scale is not None:
            pre = pre * scale.float()
        if shift is not None:
            pre = pre + shift.float()
    g = _act_grad(g, y, act, pre)
    gs = g if scale is None else g * scale.to(g.dtype)
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


def split_k_plan(m: int, n: int, k: int,
                 batch: int = 1) -> Tuple[int, int, int, int]:
    """K1's plan for an (m, k) @ (k, n) product: (tile_m, tile_n, splits,
    k_per_split). Split s covers K range [s * k_per_split, min(k, (s + 1) *
    k_per_split)); every k_per_split is a multiple of BK. With the output's
    tiles alone at WAVE_BLOCKS or more, or k below 2 * MIN_SPLIT_K, there is
    one split; otherwise as many as reach about WAVE_BLOCKS blocks while
    each keeps at least MIN_SPLIT_K of K, on 32-wide tiles: one block sums
    each tile's S partials, at a rate one SM can read, so narrower tiles
    halve that block's bytes (`chip_smoke.py --split-sweep`). ``batch``:
    the plan of the batched K1 over that many products, whose tiles all
    count toward the wave."""
    tile_n = tile_n_for(n)
    tiles = batch * -(-m // TILE_M) * -(-n // tile_n)
    if tiles < WAVE_BLOCKS and k >= 2 * MIN_SPLIT_K:
        tile_n = 32
        tiles = batch * -(-m // TILE_M) * -(-n // tile_n)
    splits = min(-(-WAVE_BLOCKS // max(tiles, 1)), k // MIN_SPLIT_K)
    if splits <= 1:
        return TILE_M, tile_n, 1, max(-(-k // BK), 1) * BK
    per_split = -(-k // splits)
    k_per_split = -(-per_split // BK) * BK
    return TILE_M, tile_n, -(-k // k_per_split), k_per_split


# K1's route on wgmma (satae_torch/csrc/fused_gemm.cu, wgmma_tile.cuh):
# 64 x 64 tiles, TMA stages of 128-byte rows -- 64 of K in bf16
# (TMA_BK), 32 in float32 (TMA_BK_F32); the splits of a tile are one
# thread-block cluster (at most 16 blocks), each split >= TMA_MIN_SPLIT_K
# of K, about TMA_WAVE_BLOCKS blocks in all: `chip_smoke.py --split-sweep`
# on an H100 measured the bf16 serving projection 512 x 4096 x 64 fastest
# at 8 splits (64 blocks) and the batch-64 one at 16. A batched launch
# aims at TMA_WAVE_BLOCKS_BATCHED blocks over all its configs: the same
# sweep at C = 45 (the vmap sweep's projection and decoder-input dX, 45
# tiles) measured 4 splits (180 blocks) fastest at both. float32 keeps
# the mma.sync loop's split plan (split_k_plan): its wgmma kernel sums each
# output element bit for bit as that loop does on the same plan (chip_smoke
# --ab holds it), so float32 results do not depend on the route; a cluster
# block holds up to MAX_SUB_F32 of the plan's partials.
TMA_BK = 64
TMA_BK_F32 = 32
TMA_MIN_SPLIT_K = 256
TMA_WAVE_BLOCKS = 64
TMA_WAVE_BLOCKS_BATCHED = 180
MAX_CLUSTER = 16
MAX_SUB_F32 = 8


def tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can read the 2-D buffer, or the 3-D stack of buffers,
    ``t``: a 16-byte-aligned base, the last axis contiguous, and every
    other stride (rows, and a stack's config stride) a multiple of 16
    bytes, none of the axes empty."""
    es, st = t.element_size(), t.stride()
    rows_ok = st[-2] * es % 16 == 0 and (len(st) == 2 or st[0] * es % 16 == 0)
    return (t.numel() > 0 and t.data_ptr() % 16 == 0 and st[-1] == 1
            and rows_ok)


# float32 launches that stay on the mma.sync loop although TMA can read
# them, where `chip_smoke.py --ab` on an H100 timed the loop faster (device
# us per launch, wgmma against mma.sync; the two sum every float32 output
# bit for bit alike, so the route changes no result):
#   N <= F32_MMA_MAX_N: the head's forward, 512 x 64 x 10 5.5 / 5.4,
#     64 x 128 x 10 7.1 / 6.4, batched C = 45 7.3 / 5.9 and C = 11 5.5 /
#     4.5 (a 64-wide wgmma tile does >= 6x the work the loop's 32-wide one
#     does);
#   an unbatched product split K into parts of F32_MMA_SPLIT_K or more:
#     the serving projection 512 x 4096 x 64, 8 splits of 512, 19.3 / 17.8
#     (each cluster block runs 16 stages in a row, ~1 us each);
#   a batched launch with an MN-major B (trans_b False: the backward's dX
#     and dW) of F32_MMA_BATCHED_MACS or more multiply-adds a config: at C
#     = 45 proj dX and dW 73.5 / 50.2 and 73.4 / 50.8, dec_in dX 69.0 /
#     62.9, dec_in dW 73.0 / 51.0 (the consumers' transposing split of B
#     takes half the time); the smaller ones there (2^19 multiply-adds: fc1
#     and the MLP's layers, 5.6-7.7 / 6.2-8.3) and every unbatched
#     MN-major B are faster on wgmma.
F32_MMA_MAX_N = 16
F32_MMA_SPLIT_K = 512
F32_MMA_BATCHED_MACS = 1 << 20


def k1_loader(x: torch.Tensor, w: torch.Tensor, trans_a: bool = False,
              trans_b: bool = False) -> str:
    """Which loader K1 runs on the buffers x and w, 2-D or (C, ., .)
    stacks, read as :func:`fused_gemm` reads them with ``trans_a`` /
    ``trans_b``: "tma" -- the wgmma
    kernel, TMA loads into an mbarrier ring (bf16, or float32 as 3xTF32) --
    for a pair that TMA can read (:func:`tma_ok`), else "cp.async",
    gemm_tile.cuh's mma.sync loop. A fixed function of dtype, shape,
    layout and alignment. The mma.sync loop keeps what TMA cannot read -- a
    base or a row or config stride that is not a multiple of 16 bytes, such
    as the head's 10-wide cotangent as the contiguous axis (20-byte bf16
    and 40-byte float32 rows: fc2's dX and dW), an odd K or N in bf16, or a
    float32 K or N that is not a multiple of 4 -- and the float32 launches
    it runs faster (the rules above F32_MMA_MAX_N)."""
    if not (tma_ok(x) and tma_ok(w)):
        return "cp.async"
    if x.dtype != torch.float32:
        return "tma"
    xs = x.shape
    m, k = (xs[-1], xs[-2]) if trans_a else (xs[-2], xs[-1])
    n = w.shape[-2] if trans_b else w.shape[-1]
    if n <= F32_MMA_MAX_N:
        return "cp.async"
    if len(xs) == 3:  # a config axis
        return ("cp.async" if not trans_b
                and m * n * k >= F32_MMA_BATCHED_MACS else "tma")
    if k < 2 * F32_MMA_SPLIT_K:  # no split of that depth
        return "tma"
    _, _, splits, k_per_split = split_k_plan(m, n, k)
    return ("cp.async" if splits > 1 and k_per_split >= F32_MMA_SPLIT_K
            else "tma")


# K1's wide route (satae_torch/csrc/gemm_wide.cu): 128 x 256 tiles, two
# consumer warpgroups on wgmma m64n256k16, one persistent block an SM, for
# the ViT encoder's large products, which are bound by operations. It takes
# N a multiple of WIDE_TILE_N (the ViT's 768, 2,304 and 3,072: no masked
# columns), K a multiple of the 64-deep stage and at least WIDE_MIN_K, and
# at least WIDE_MIN_TILES output tiles, one wave of blocks on a 132-SM
# H100. The thresholds scope the route; they do not mark where it stops
# winning: `chip_smoke.py --vit` on an H100 timed it faster than the 64 x
# 64 route below both (device us, wide / 64 x 64, at N = 768: M = 37,696
# and K = 64, 128, 256 33.5 / 68.1, 38.6 / 82.9, 47.6 / 108.2; K = 768 and
# 48, 96, 198 tiles 13.6 / 17.2, 13.9 / 25.2, 24.7 / 49.2). WIDE_MIN_K keeps
# the decoder input (K = 64) on the route whose bits the tests and
# `chip_smoke.py --ab` hold, as N % WIDE_TILE_N keeps every other product
# of the autoencoder's paths (N <= 128).
WIDE_TILE_M = 128
WIDE_TILE_N = 256
WIDE_MIN_K = 256
WIDE_MIN_TILES = 132


def k1_wide(x: torch.Tensor, w: torch.Tensor, trans_a: bool = False,
            trans_b: bool = False) -> bool:
    """Whether K1 runs its wide kernel on the buffers x and w, read as
    :func:`fused_gemm` reads them: a fixed function of dtype, shape, layout
    and alignment, like :func:`k1_loader`. True for a bf16, unbatched
    product with A row-major and B a (K, N) buffer (neither transposed)
    that TMA can read, which :func:`split_k_plan_tma` does not split, with
    N a multiple of WIDE_TILE_N, K a multiple of TMA_BK and at least
    WIDE_MIN_K, and at least WIDE_MIN_TILES tiles of WIDE_TILE_M x
    WIDE_TILE_N: the ViT encoder's linears. Every other launch -- the
    autoencoder's (N <= 128, the decoder input's K = 64), any batched, any
    float32 one, every dX and dW (an operand read transposed) -- keeps
    :func:`k1_loader`'s route."""
    if x.dtype != torch.bfloat16 or x.dim() != 2 or trans_a or trans_b:
        return False
    m, k = x.shape
    n = w.shape[1]
    return (n % WIDE_TILE_N == 0 and k % TMA_BK == 0 and k >= WIDE_MIN_K
            and -(-m // WIDE_TILE_M) * (n // WIDE_TILE_N) >= WIDE_MIN_TILES
            and split_k_plan_tma(m, n, k)[2] == 1
            and tma_ok(x) and tma_ok(w))


def gelu_ok(x: torch.Tensor, w: torch.Tensor, trans_a: bool,
            trans_b: bool) -> bool:
    """Whether K1 on the card computes act "gelu" for these buffers: bf16,
    on the wgmma route (:func:`k1_loader`), neither operand transposed (the
    one instantiation built with the GELU in its epilogue)."""
    return (x.dtype == torch.bfloat16 and not trans_a and not trans_b
            and k1_loader(x, w, trans_a, trans_b) == "tma")


def _check_gelu(what: str, x, w, act, trans_a, trans_b) -> None:
    if act == "gelu" and not gelu_ok(x, w, trans_a, trans_b):
        raise ValueError(f"{what}: act 'gelu' runs on K1's bf16 wgmma "
                         f"route with row-major A and a (K, N) B only; got "
                         f"{x.dtype}, trans_a={trans_a}, trans_b={trans_b}")


def split_k_plan_tma(m: int, n: int, k: int, batch: int = 1,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[int, int, int, int]:
    """The plan of K1's TMA route for an (m, k) @ (k, n) product in
    ``dtype``: (tile_m, tile_n, splits, k_per_split), 64 x 64 tiles. Split
    s covers K range [s * k_per_split, min(k, (s + 1) * k_per_split)),
    k_per_split a multiple of the dtype's stage (TMA_BK of K in bf16,
    TMA_BK_F32 in float32), so no stage straddles two splits.

    float32: :func:`split_k_plan`'s splits and k_per_split (its own 32- or
    64-wide tiles aside), so the wgmma kernel's sums are the mma.sync
    loop's bit for bit; its cluster has ceil(splits / sub) blocks of sub
    consecutive partials each, sub the least power of two that keeps the
    cluster within 16 blocks (split_k_plan gives at most 128 = 16 *
    MAX_SUB_F32 splits).

    bf16: the splits of a tile form one cluster, so splits <= MAX_CLUSTER.
    With the output's tiles alone at TMA_WAVE_BLOCKS or more, or k below 2
    * TMA_MIN_SPLIT_K, there is one split; otherwise as many as reach about
    TMA_WAVE_BLOCKS blocks while each keeps at least TMA_MIN_SPLIT_K of K:
    fewer blocks than the mma.sync plan's, since a cluster's in-order
    reduction grows with the splits. ``batch``: the plan of the batched K1
    over that many products, every config's tiles counted toward
    TMA_WAVE_BLOCKS_BATCHED, never more splits than one product's plan."""
    if dtype == torch.float32:
        return (TILE_M, TILE_M) + split_k_plan(m, n, k, batch)[2:]
    tiles = batch * -(-m // TILE_M) * -(-n // TILE_M)
    wave = TMA_WAVE_BLOCKS if batch == 1 else TMA_WAVE_BLOCKS_BATCHED
    stages = max(-(-k // TMA_BK), 1)
    splits = 1
    if tiles < wave and k >= 2 * TMA_MIN_SPLIT_K:
        splits = min(MAX_CLUSTER, -(-wave // tiles), k // TMA_MIN_SPLIT_K)
        if batch > 1:
            splits = min(splits, split_k_plan_tma(m, n, k)[2])
    k_per_split = -(-stages // splits) * TMA_BK
    return TILE_M, TILE_M, max(-(-k // k_per_split), 1), k_per_split


def split_k_workspace(m: int, n: int, splits: int,
                      device) -> Optional[torch.Tensor]:
    """The float32 partials of a split-K launch (of float32 or bf16
    operands), splits * m * n of them; None for one split."""
    if splits == 1:
        return None
    return torch.empty(splits * m * n, device=device, dtype=torch.float32)


class launch_span:
    """``with launch_span(name, wrapper, dtype[, batched]): <one launch>``:
    the launch inside the span ``name`` (on the card too, :func:`span`'s
    ``device=True``, with the span's ``counts``), counted as one launch of
    ``wrapper``'s kernel in ``dtype``'s instantiation when the block ends
    without raising, whether or not a profiler is on: in
    ``wrapper.launches``, or for a K1 launch over a leading config axis
    (``batched``) in ``wrapper.batched_launches``. A ``wrapper`` of None
    counts nothing."""
    __slots__ = ("span", "counter", "key")

    def __init__(self, name: str, wrapper, dtype: torch.dtype,
                 batched: bool = False, **counts: float):
        self.span = span(name, device=True, **counts)
        self.counter = None if wrapper is None else (
            wrapper.batched_launches if batched else wrapper.launches)
        self.key = _build.OPERAND_DTYPES[dtype]

    def __enter__(self) -> None:
        self.span.__enter__()

    def __exit__(self, *exc) -> bool:
        self.span.__exit__(*exc)
        if exc[0] is None and self.counter is not None:
            self.counter[self.key] += 1
        return False


# one int32 counter per output tile of a split-K launch, per device; a
# split-K plan has fewer than WAVE_BLOCKS tiles over all its configs, and
# the kernel leaves every counter at 0
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
               trans_a: bool = False, trans_b: bool = False, *,
               counted=None) -> torch.Tensor:
    """One launch of K1 on CUDA tensors: act((A @ B) * scale + shift) with
    A = x, or x read in place as its transpose (``trans_a``: x is a (K, M)
    buffer), and B = w, or w read in place as its transpose (``trans_b``: w
    is an (N, K) buffer), in x's dtype, float32 or bf16; scale and shift
    (N,). With a leading config axis -- x C x (M, K) or C x (K, M), w C x
    (K, N) or C x (N, K), scale and shift (C, N) -- the C products are one
    launch, out (C, M, N); 2-D operands are C = 1.

    The route: :func:`fused_gemm_wide` where :func:`k1_wide` takes the
    launch (2-D only), else ``satae_fused_gemm_batched_tma`` /
    ``_batched_bf16_tma`` on wgmma where :func:`k1_loader` says "tma", with
    ``split_k_plan_tma(m, n, k, batch=C, dtype=x.dtype)``, else
    ``satae_fused_gemm_batched`` / ``_batched_bf16`` on the mma.sync loop
    with ``split_k_plan(m, n, k, batch=C)``, where a split-K launch takes a
    workspace of C * splits * M * N floats. A scale or shift of None is 1 or
    0, and nothing is allocated for it. Raises on a refused launch; never
    falls back to C launches. The launch runs inside the span ``satae.k1``
    (:class:`launch_span`), whose counter ``wide`` is 1 on the wide route
    and 0 on the others, and is counted in ``counted``, the wrapper the
    training and serving paths pass (:func:`fused_matmul`,
    :func:`fused_matmul_bwd`): a 3-D launch in its ``batched_launches``;
    None counts nothing."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_gemm: K1 runs on CUDA tensors, x is on "
                         f"{x.device}")
    xs, wsh = x.shape, w.shape
    batched = len(xs) == 3
    if len(xs) not in (2, 3) or len(wsh) != len(xs) or (
            batched and wsh[0] != xs[0]):
        raise ValueError(f"fused_gemm: x {tuple(xs)} and w {tuple(wsh)} "
                         "must be (., .) or (C, ., .) of one C")
    c = xs[0] if batched else 1
    m, k = (xs[-1], xs[-2]) if trans_a else (xs[-2], xs[-1])
    n, kw = (wsh[-2], wsh[-1]) if trans_b else (wsh[-1], wsh[-2])
    if k != kw:
        raise ValueError(f"fused_gemm: inner sizes {k} and {kw} differ")
    suffix = _build.check_operands("fused_gemm", x.device, x, w,
                                   scale=scale, shift=shift)
    if max(c * m * k, c * k * n, c * m * n) >= 2 ** 31:
        raise ValueError(f"fused_gemm: {c} x {(m, k, n)} exceeds int32 "
                         "indexing")
    vec = (c, n) if batched else (n,)
    if any(t is not None and t.shape != vec for t in (scale, shift)):
        raise ValueError(f"fused_gemm: scale/shift must be {vec}")
    _check_gelu("fused_gemm", x, w, act, trans_a, trans_b)
    out = torch.empty((c, m, n) if batched else (m, n), device=x.device,
                      dtype=x.dtype)
    if c == 0 or m == 0 or n == 0:
        return out
    if k1_wide(x, w, trans_a, trans_b):
        fused_gemm_wide(x, w, scale, shift, act, out, counted=counted)
        return out
    if k1_loader(x, w, trans_a, trans_b) == "tma":
        _, _, splits, k_per_split = split_k_plan_tma(m, n, k, batch=c,
                                                     dtype=x.dtype)
        with launch_span("satae.k1", counted, x.dtype, batched, wide=0):
            _build.launch(_build.load("fused_gemm"),
                          "satae_fused_gemm_batched" + suffix + "_tma",
                          x.device, x.data_ptr(), w.data_ptr(), _ptr(scale),
                          _ptr(shift), out.data_ptr(), c, m, n, k,
                          ACTS.index(act), int(trans_a), int(trans_b), splits,
                          k_per_split)
        return out
    _, tile_n, splits, k_per_split = split_k_plan(m, n, k, batch=c)
    ws = split_k_workspace(c * m, n, splits, x.device)
    counters = None if ws is None else _tile_counters(x.device)
    with launch_span("satae.k1", counted, x.dtype, batched, wide=0):
        _build.launch(_build.load("fused_gemm"),
                      "satae_fused_gemm_batched" + suffix, x.device,
                      x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(shift),
                      out.data_ptr(), _ptr(ws), _ptr(counters), c, m, n, k,
                      ACTS.index(act), int(trans_a), int(trans_b), tile_n,
                      splits, k_per_split)
    return out


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def fused_gemm_wide(x: torch.Tensor, w: torch.Tensor,
                    scale: Optional[torch.Tensor],
                    shift: Optional[torch.Tensor], act: str,
                    out: torch.Tensor, *, counted=None) -> None:
    """One launch of K1's wide kernel into ``out`` (M, N): act((x @ w) *
    scale + shift) for bf16 x (M, K) and w (K, N) that :func:`k1_wide`
    takes (:func:`fused_gemm` checks and routes them), launched by
    ``satae_fused_gemm_bf16_wide`` (satae_torch/csrc/gemm_wide.cu) inside
    the span ``satae.k1`` with the counter ``wide`` at 1, counted in
    ``counted.launches`` as :func:`fused_gemm` counts, and in this
    function's own ``launches``."""
    m, k = x.shape
    with launch_span("satae.k1", counted, x.dtype, wide=1):
        _build.launch(_build.load("gemm_wide"), "satae_fused_gemm_bf16_wide",
                      x.device, x.data_ptr(), w.data_ptr(), _ptr(scale),
                      _ptr(shift), out.data_ptr(), m, w.shape[1], k,
                      ACTS.index(act))
    fused_gemm_wide.launches[_build.OPERAND_DTYPES[x.dtype]] += 1


fused_gemm_wide.launches = _build.launch_counter()


def fused_matmul_bwd(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     scale: Optional[torch.Tensor], y: torch.Tensor,
                     act: str = "none",
                     needs: Sequence[bool] = (True, True, True, True),
                     w_nk: bool = False, *,
                     shift: Optional[torch.Tensor] = None) -> Grads:
    """The backward of :func:`fused_matmul`, step by step as satae's
    ``_bwd``: g through the activation, gs = g * scale, then dx = gs @ W^T
    and dw = x^T @ gs (or gs^T @ x for an (N, K) weight) as one K1 launch
    each, and z = x @ W recomputed on K1 for dscale only when ``needs[2]``.
    The activation gradient, the scale product and the column sums stay
    PyTorch ops, as they stay XLA ops outside the Pallas kernel in satae;
    all but the float32 column sums run in g's dtype. For "gelu" the
    activation's input is one more K1 launch (act "none", scale and
    ``shift``). Operands with a leading config axis (C, ., .) take one
    launch per product over all configs, dscale and dshift (C, N).

    A CUDA x launches K1 (counted in ``fused_matmul_bwd.launches``, a 3-D
    launch in ``fused_matmul_bwd.batched_launches``); a CPU x takes
    :func:`fused_matmul_bwd_plain`."""
    if x.device.type == "cpu":
        return fused_matmul_bwd_plain(g, x, w, scale, y, act, needs, w_nk,
                                      shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_bwd: no kernel for device {x.device}")
    pre = None
    if act == "gelu":
        pre = fused_gemm(x, w, scale, shift, "none", False, w_nk,
                         counted=fused_matmul_bwd)
    g = _act_grad(g, y, act, pre)
    gs = (g if scale is None else
          g * scale.unsqueeze(-2).to(g.dtype)).contiguous()

    def product(a, b, trans_a, trans_b):  # scale 1, shift 0, no act
        return fused_gemm(a, b, None, None, "none", trans_a, trans_b,
                          counted=fused_matmul_bwd)

    dx = dw = dscale = None
    if needs[0]:  # dx (M, K) = gs @ W^T; an (N, K) weight is that B as it is
        dx = product(gs, w, False, not w_nk)
    if needs[1]:  # dw (N, K) = gs^T @ x, or dw (K, N) = x^T @ gs
        dw = product(gs, x, True, False) if w_nk else \
            product(x, gs, True, False)
    if needs[2]:
        dscale = (g * product(x, w, False, w_nk)).sum(-2).float()
    dshift = g.sum(-2).float() if needs[3] else None
    return dx, dw, dscale, dshift


fused_matmul_bwd.launches = _build.launch_counter()
fused_matmul_bwd.batched_launches = _build.launch_counter()


def _forward(x, w, scale, shift, act, w_nk):
    if x.device.type == "cuda":
        return fused_gemm(x, w, scale, shift, act, False, w_nk,
                          counted=fused_matmul)
    return fused_matmul_plain(x, w.transpose(-1, -2) if w_nk else w, scale,
                              shift, act)


class _FusedMatmul(torch.autograd.Function):
    """K1 (or its plain version) with satae's VJP as the backward."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, act, w_nk):
        y = _forward(x, w, scale, shift, act, w_nk)
        ctx.save_for_backward(x, w, scale, y,
                              shift if act == "gelu" else None)
        ctx.act, ctx.w_nk = act, w_nk
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, y, shift = ctx.saved_tensors
        grads = fused_matmul_bwd(g, x, w, scale, y, ctx.act,
                                 ctx.needs_input_grad[:4], ctx.w_nk,
                                 shift=shift)
        return (*grads, None, None)


def fused_matmul(x: torch.Tensor, w: torch.Tensor,
                 scale: Optional[torch.Tensor], shift: torch.Tensor,
                 act: str = "none", *, w_nk: bool = False) -> torch.Tensor:
    """act((x @ W) * scale + shift) for x (M, K), per-column scale/shift
    (N,), and W = w, a row-major (K, N) weight, or W = w.T for an (N, K)
    weight with ``w_nk=True`` (an ``nn.Linear`` weight, read in place).
    With a leading config axis, C products at once (satae's layers under
    ``jax.vmap``): x (C, M, K), w (C, K, N) or (C, N, K), scale and shift
    (C, N) -> (C, M, N), one launch on the card.
    A scale of None is 1 (a linear layer: nothing is allocated for it).
    x and w are both float32 or both bf16, scale and shift float32; the
    output is in x's dtype. Differentiable in x, w, scale and shift
    (:func:`fused_matmul_bwd`).

    A CUDA x launches K1 (counted in ``fused_matmul.launches``, a 3-D
    launch in ``fused_matmul.batched_launches``); a CPU x takes
    :func:`fused_matmul_plain`."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    xs, wsh = x.shape, w.shape
    batched = len(xs) == 3
    if (len(xs) not in (2, 3) or len(wsh) != len(xs)
            or (batched and wsh[0] != xs[0])
            or xs[-1] != wsh[-1 if w_nk else -2]):
        raise ValueError(f"fused_matmul: bad shapes x {tuple(xs)}, "
                         f"w {tuple(wsh)}{' (N, K)' if w_nk else ''}")
    n = wsh[-2 if w_nk else -1]
    vec = (xs[0], n) if batched else (n,)
    if (scale is not None and scale.shape != vec) or shift.shape != vec:
        raise ValueError(f"fused_matmul: scale/shift must be {vec}, got "
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
fused_matmul.batched_launches = _build.launch_counter()
