"""The work of serving a Swin Transformer V2 encoder and the pipeline's MLP
head, counted from the configuration's shapes, as portbench.work_vit counts
a ViT's: the yardstick of the Swin cell's MFU and of its per-kernel
roofline shares.

Per call, real chips only, each operation's inputs (its weights too) read
once and its outputs written once, activations in the compute dtype (bf16:
2 bytes), biases, LayerNorm parameters, position biases and logit scales
float32, the head float32:

* ``embed``: the int16 chip read, its scaled patch matrix written;
* ``patch``: the patch embedding, a GEMM (side^2 x in_chans * patch^2) @
  (.. x embed_dim), and ``embed_norm``, its LayerNorm;
* per block: ``qkv``, ``wattn`` (S = Q K^T and P V over the 64 tokens of a
  token's window: 4 * 64 * C operations a token; qkv read, the heads'
  output written, the head's position-bias table and scale read), ``proj``,
  ``ln1`` (post-norm: the branch and the residual stream read, the stream
  written), ``fc1``, ``fc2``, ``ln2``;
* between stages: ``red``, the merge's reduction GEMM (side^2 / 4 x 4C) @
  (4C x 2C) with no bias, reading the stage's output once (the 2 x 2 gather
  is how the rows are read, no work of its own), and ``merge_norm``;
* ``pool``: the last stage's tokens read, the latent written (float32);
* ``head{i}``: the MLP's linears, float32, at the float32 peak.

Least time of an operation: max(operations / peak, bytes / HBM rate),
portbench.work's ``Op``. The counts do not depend on how the program
implements the work, so no kernel name is read.
"""

from __future__ import annotations

from typing import Dict, List

from portbench import work as W

GEMMS = ("patch", "qkv", "proj", "fc1", "fc2", "red")
NORMS = ("embed_norm", "ln1", "ln2", "merge_norm")
WINDOW_TOKENS = 64


def ops(m: dict, head: dict, dtype: str, chips: int) -> List[W.Op]:
    """The served forward of ``chips`` chips, ``m`` the Swin's widths and
    ``head`` the MLP's (latent_dim, mlp_hidden, num_classes)."""
    b = W.DTYPE_BYTES[dtype]
    n, p, c_in = chips, m["patch_size"], m["in_chans"]
    side = m["img_size"] // p
    e = m["embed_dim"]
    win = m["window_size"] ** 2

    def gemm(name, rows, k, out, bias=True):
        return W.Op(name, 2.0 * n * rows * k * out,
                    (n * rows * (k + out) + k * out) * b
                    + (out * 4 if bias else 0))

    def norm(name, rows, d, post):
        return W.Op(name, 0.0,
                    n * rows * d * b * (3 if post else 2) + 2 * d * 4)

    out = [W.Op("embed", 0.0, n * c_in * m["img_size"] ** 2 * (2 + b)),
           gemm("patch", side * side, c_in * p * p, e),
           norm("embed_norm", side * side, e, False)]
    for i, (depth, heads) in enumerate(zip(m["depths"], m["num_heads"])):
        d, t = e * 2 ** i, (side // 2 ** i) ** 2
        k_mlp = int(d * m["mlp_ratio"])
        for j in range(depth):
            pre = f"stage{i}.block{j}."
            out += [gemm(pre + "qkv", t, d, 3 * d),
                    W.Op(pre + "wattn", 4.0 * n * t * win * d,
                         n * t * 4 * d * b + heads * (win * win + 1) * 4),
                    gemm(pre + "proj", t, d, d), norm(pre + "ln1", t, d, True),
                    gemm(pre + "fc1", t, d, k_mlp),
                    gemm(pre + "fc2", t, k_mlp, d),
                    norm(pre + "ln2", t, d, True)]
        if i + 1 < len(m["depths"]):
            pre = f"stage{i}."
            out += [gemm(pre + "red", t // 4, 4 * d, 2 * d, bias=False),
                    norm(pre + "merge_norm", t // 4, 2 * d, False)]
    last = e * 2 ** (len(m["depths"]) - 1)
    t_last = (side // 2 ** (len(m["depths"]) - 1)) ** 2
    out.append(W.Op("pool", 0.0, n * (t_last * last * b + last * 4)))
    dims = [head["latent_dim"]] + list(head["mlp_hidden"]) \
        + [head["num_classes"]]
    for i, (a, c) in enumerate(zip(dims[:-1], dims[1:])):
        out.append(W.Op(f"head{i}", 2.0 * n * a * c,
                        n * (a + c) * 4 + (a * c + 2 * c) * 4))
    return out


def kind_of(op: W.Op) -> str:
    """``gemm``, ``wattn``, ``ln``, ``head`` or ``other`` (embed, pool)."""
    last = op.name.rsplit(".", 1)[-1]
    if last in GEMMS:
        return "gemm"
    if last == "wattn":
        return "wattn"
    if last in NORMS:
        return "ln"
    if last.startswith("head"):
        return "head"
    return "other"


def least_s(ops: List[W.Op], peak: Dict[str, float], dtype: str) -> float:
    """Least time of ``ops``: the head's at the float32 peak (it computes in
    float32), every other at ``peak``."""
    f32 = {"flops": W.PEAK_FLOPS["float32"], "bytes": peak["bytes"]}
    return sum(op.least_s(f32 if kind_of(op) == "head" and dtype
                          != "float32" else peak) for op in ops)


def work(m: dict, head: dict, dtype: str, chips: int,
         peak: Dict[str, float]) -> Dict[str, float]:
    """Per call of ``chips`` chips: the FLOPs, the least time of the whole
    forward, and of its window attention (``wattn_least_s``), LayerNorm
    (``ln_least_s``) and K1 launches (``gemm_least_s``: the Swin's linears
    and the head's)."""
    got = ops(m, head, dtype, chips)
    by = lambda *kinds: [op for op in got if kind_of(op) in kinds]
    return {"flops": sum(op.flops for op in got),
            "least_s": least_s(got, peak, dtype),
            "wattn_least_s": least_s(by("wattn"), peak, dtype),
            "ln_least_s": least_s(by("ln"), peak, dtype),
            "gemm_least_s": least_s(by("gemm", "head"), peak, dtype)}
