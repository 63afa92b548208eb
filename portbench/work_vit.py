"""The work of serving a ViT encoder and the pipeline's MLP head, counted from
the configuration's shapes, for the cells that serve one: the yardstick of
their MFU and of their per-kernel roofline shares.

Per call, real chips only, each operation's inputs (its weights too) read
once and its outputs written once, activations in the compute dtype (bf16:
2 bytes), biases and LayerNorm parameters float32, the head float32:

* ``embed``: the int16 chip read, its normalised patch matrix written;
* ``patch``: the patch embedding, a GEMM (patches x in_chans * tubelet *
  patch^2) @ (.. x d), plus the position table's add (one read, one write
  of the tokens);
* per block: ``ln1``, ``qkv``, ``attn`` (q k^T and P v: 4 L^2 d operations;
  qkv read, the heads' output written), ``proj``, ``ln2``, ``fc1``,
  ``fc2``; a LayerNorm reads its rows (and the residual branch, but for the
  first block's first) and writes the normalised rows (and the sum);
* ``norm``: the final LayerNorm, with the last residual add;
* ``pool``: the patch tokens read, the latent written (float32);
* ``head{i}``: the MLP's linears, float32, at the float32 peak.

Least time of an operation: max(operations / peak, bytes / HBM rate),
portbench.work's ``Op``. The counts do not depend on how the program
implements the work, so no kernel name is read.
"""

from __future__ import annotations

from typing import Dict, List

from portbench import work as W

GEMMS = ("patch", "qkv", "proj", "fc1", "fc2")


def ops(m: dict, head: dict, dtype: str, chips: int) -> List[W.Op]:
    """The served forward of ``chips`` chips, ``m`` the ViT's widths and
    ``head`` the MLP's (latent_dim, mlp_hidden, num_classes); every weight
    read once."""
    b = W.DTYPE_BYTES[dtype]
    side = m["img_size"] // m["patch_size"]
    patches = (m["num_frames"] // m["tubelet_size"]) * side * side
    L, d = patches + 1, m["embed_dim"]
    k_mlp = int(d * m["mlp_ratio"])
    k_patch = m["in_chans"] * m["tubelet_size"] * m["patch_size"] ** 2
    pixels = m["in_chans"] * m["num_frames"] * m["img_size"] ** 2
    n = chips

    def gemm(name, rows, k, out):
        return W.Op(name, 2.0 * n * rows * k * out,
                    (n * rows * (k + out) + k * out) * b + out * 4)

    def ln(name, residual):
        return W.Op(name, 0.0,
                    n * L * d * b * (4 if residual else 2) + 2 * d * 4)

    out = [W.Op("embed", 0.0, n * pixels * (2 + b)),
           gemm("patch", patches, k_patch, d),
           W.Op("pos", 0.0, n * (2.0 * L * d * b + patches * d * b))]
    for i in range(m["depth"]):
        out += [ln(f"block{i}.ln1", i > 0),
                gemm(f"block{i}.qkv", L, d, 3 * d),
                W.Op(f"block{i}.attn", 4.0 * n * L * L * d, n * L * 4 * d * b),
                gemm(f"block{i}.proj", L, d, d), ln(f"block{i}.ln2", True),
                gemm(f"block{i}.fc1", L, d, k_mlp),
                gemm(f"block{i}.fc2", L, k_mlp, d)]
    out += [ln("norm", True),
            W.Op("pool", 0.0, n * (patches * d * b + d * 4))]
    dims = [head["latent_dim"]] + list(head["mlp_hidden"]) \
        + [head["num_classes"]]
    for i, (a, c) in enumerate(zip(dims[:-1], dims[1:])):
        out.append(W.Op(f"head{i}", 2.0 * n * a * c,
                        n * (a + c) * 4 + (a * c + 2 * c) * 4))
    return out


def kind_of(op: W.Op) -> str:
    """``gemm``, ``attn``, ``ln``, ``head`` or ``other`` (embed, pos,
    pool)."""
    last = op.name.rsplit(".", 1)[-1]
    if last in GEMMS:
        return "gemm"
    if last == "attn":
        return "attn"
    if last in ("ln1", "ln2", "norm"):
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
    forward, and of its attention (``attn_least_s``), LayerNorm
    (``ln_least_s``) and K1 launches (``gemm_least_s``: the ViT's linears
    and the head's)."""
    got = ops(m, head, dtype, chips)
    by = lambda *kinds: [op for op in got if kind_of(op) in kinds]
    return {"flops": sum(op.flops for op in got),
            "least_s": least_s(got, peak, dtype),
            "attn_least_s": least_s(by("attn"), peak, dtype),
            "ln_least_s": least_s(by("ln"), peak, dtype),
            "gemm_least_s": least_s(by("gemm", "head"), peak, dtype)}
