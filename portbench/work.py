"""The work a cell asks of the card, counted from its shapes, and the card's
peaks: the yardstick of the per-layer shares and of the MFUs.

Each layer operation has its operations (2 per multiply-add) and its
bytes: each input read once and each output written once, activations in
the compute dtype, for real rows only. Its least time on the card is
max(operations / peak, bytes / HBM rate). The counts do not depend on how
the program implements the operation, so no kernel name is read.

:func:`train_flops_per_image` and :func:`param_count` are copies of
``satae_torch/utils/roofline.py`` (``kind="model"``): the useful math of
the notebook's architecture, the transposed convolutions counted as their
forward-equivalent convolutions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit. float32
# cells take the TF32 tensor-core rate: no path that keeps float32's
# accuracy computes faster on this card, so no share can pass 100 %.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_HBM = 3.35e12
CARDS = ("NVIDIA H100",)

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def peaks(device_name: str, dtype: str) -> Optional[Dict[str, float]]:
    """{"flops", "bytes"} per second for ``dtype`` on a card of this name,
    or None for a card the table does not hold."""
    if not any(device_name.startswith(c) for c in CARDS):
        return None
    return {"flops": PEAK_FLOPS[dtype], "bytes": PEAK_HBM}


@dataclass(frozen=True)
class Op:
    name: str
    flops: float
    bytes: float

    def least_s(self, peak: Dict[str, float]) -> float:
        return max(self.flops / peak["flops"], self.bytes / peak["bytes"])


def least_s(ops: List[Op], peak: Dict[str, float]) -> float:
    return sum(op.least_s(peak) for op in ops)


# ---- shapes ------------------------------------------------------------------

def _enc_layers(m: dict, image_size: int, channels: int):
    """(cin, cout, in side, out side) of each encoder convolution."""
    chans = [channels] + list(m["encoder_channels"])
    return [(chans[i], chans[i + 1], image_size // 2 ** i,
             image_size // 2 ** (i + 1)) for i in range(len(chans) - 1)]


def _dec_layers(m: dict, image_size: int, channels: int):
    """(cin, cout, in side, out side) of each transposed convolution."""
    rev = list(reversed(m["encoder_channels"])) + [channels]
    n = len(m["encoder_channels"])
    return [(rev[i], rev[i + 1], image_size // 2 ** (n - i),
             image_size // 2 ** (n - i - 1)) for i in range(n)]


def _feat(m: dict, image_size: int) -> int:
    n = len(m["encoder_channels"])
    return (image_size // 2 ** n) ** 2 * m["encoder_channels"][-1]


def param_count(m: dict, image_size: int, channels: int) -> int:
    """Supervised-AE parameters (conv / linear weights and biases, BatchNorm
    scale and bias)."""
    n = 0
    for cin, cout, _, _ in _enc_layers(m, image_size, channels):
        n += 9 * cin * cout + cout + 2 * cout
    feat, lat = _feat(m, image_size), m["latent_dim"]
    n += feat * lat + lat + lat * feat + feat
    dec = _dec_layers(m, image_size, channels)
    for i, (cin, cout, _, _) in enumerate(dec):
        n += 9 * cin * cout + cout + (2 * cout if i < len(dec) - 1 else 0)
    n += lat * m["head_hidden"] + m["head_hidden"]
    n += m["head_hidden"] * m["num_classes"] + m["num_classes"]
    return n


def train_flops_per_image(m: dict, image_size: int, channels: int) -> float:
    """FLOPs of one train step per image, the notebook's useful math:
    forward, and a backward of twice the forward's products less the first
    convolution's input gradient (its input is the augmented image)."""
    enc = sum(so * so * cout * 9 * cin
              for cin, cout, _, so in _enc_layers(m, image_size, channels))
    dec = sum(si * si * cin * cout * 9
              for cin, cout, si, _ in _dec_layers(m, image_size, channels))
    proj = _feat(m, image_size) * m["latent_dim"] * 2
    head = m["latent_dim"] * m["head_hidden"] \
        + m["head_hidden"] * m["num_classes"]
    fwd = enc + dec + proj + head
    cin, cout, _, so = _enc_layers(m, image_size, channels)[0]
    conv0 = so * so * cout * 9 * cin
    return 2.0 * (fwd + 2 * fwd - conv0)


# ---- serving -------------------------------------------------------------------

def serve_forward_macs_per_image(m: dict, image_size: int,
                                 channels: int) -> float:
    """Multiply-adds of the served forward of one image: the four
    convolutions, the projection, the three MLP linears."""
    convs = sum(so * so * cout * 9 * cin
                for cin, cout, _, so in _enc_layers(m, image_size, channels))
    dims = [m["latent_dim"]] + list(m["mlp_hidden"]) + [m["num_classes"]]
    mlp = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return convs + _feat(m, image_size) * m["latent_dim"] + mlp


def serve_ops(m: dict, image_size: int, channels: int, dtype: str,
              images: int) -> List[Op]:
    """The served forward of ``images`` real rows: normalize (uint8 in,
    compute dtype out), conv + BatchNorm + ReLU per encoder layer, the
    projection (compute dtype, latents out in float32), and the float32
    MLP; every weight, scale and shift read once."""
    b = DTYPE_BYTES[dtype]
    n = images
    side = image_size
    ops = [Op("normalize", 0.0, n * side * side * channels * (1 + b))]
    for i, (cin, cout, si, so) in enumerate(
            _enc_layers(m, image_size, channels)):
        macs = n * so * so * cout * 9 * cin
        nbytes = (n * (si * si * cin + so * so * cout) * b
                  + 9 * cin * cout * b + 2 * cout * 4)
        ops.append(Op(f"conv{i}", 2.0 * macs, nbytes))
    feat, lat = _feat(m, image_size), m["latent_dim"]
    ops.append(Op("proj", 2.0 * n * feat * lat,
                  n * (feat * b + lat * 4) + feat * lat * b + 2 * lat * 4))
    dims = [lat] + list(m["mlp_hidden"]) + [m["num_classes"]]
    for i, (a, c) in enumerate(zip(dims[:-1], dims[1:])):
        ops.append(Op(f"mlp{i}", 2.0 * n * a * c,
                      n * (a + c) * 4 + (a * c + 2 * c) * 4))
    return ops


# ---- training --------------------------------------------------------------------

def train_ops(m: dict, image_size: int, channels: int, dtype: str,
              batch: int, configs: int = 1) -> List[Op]:
    """One train step of ``configs`` configs at ``batch`` rows each: per
    convolution, transposed convolution and linear its forward, input
    gradient (none for the first convolution) and weight gradient; per
    BatchNorm (+ ReLU) its forward and backward; the sigmoid and the loss;
    Adam's update of the float32 master parameters and moments (read p, g,
    m, v; write p, m, v). Activations and weights in the compute dtype."""
    b = DTYPE_BYTES[dtype]
    rows = batch * configs
    ops: List[Op] = []

    def product(name, macs, x_el, w_el, y_el, first=False):
        """forward y = x * w, input gradient dx = dy * w, weight gradient
        dw = x * dy, each reading its operands once and writing its result
        once (x_el, y_el per row, w_el per config)."""
        ops.append(Op(f"{name}.fwd", 2.0 * rows * macs,
                      (rows * (x_el + y_el) + configs * w_el) * b))
        if not first:
            ops.append(Op(f"{name}.dx", 2.0 * rows * macs,
                          (rows * (y_el + x_el) + configs * w_el) * b))
        ops.append(Op(f"{name}.dw", 2.0 * rows * macs,
                      (rows * (x_el + y_el)) * b + configs * w_el * 4))

    def batchnorm(name, el):
        # forward: read y, write the normalised activation; backward: read
        # the activation's gradient and y, write y's gradient
        ops.append(Op(f"{name}.fwd", 0.0, 2 * rows * el * b))
        ops.append(Op(f"{name}.bwd", 0.0, 3 * rows * el * b))

    for i, (cin, cout, si, so) in enumerate(
            _enc_layers(m, image_size, channels)):
        product(f"enc{i}", so * so * cout * 9 * cin, si * si * cin,
                9 * cin * cout, so * so * cout, first=(i == 0))
        batchnorm(f"enc{i}.bn", so * so * cout)
    feat, lat = _feat(m, image_size), m["latent_dim"]
    product("proj", feat * lat, feat, feat * lat, lat)
    product("dec_in", lat * feat, lat, feat * lat, feat)
    dec = _dec_layers(m, image_size, channels)
    for i, (cin, cout, si, so) in enumerate(dec):
        product(f"dec{i}", si * si * cin * cout * 9, si * si * cin,
                9 * cin * cout, so * so * cout)
        if i < len(dec) - 1:
            batchnorm(f"dec{i}.bn", so * so * cout)
    hh, k = m["head_hidden"], m["num_classes"]
    product("head0", lat * hh, lat, lat * hh, hh)
    product("head1", hh * k, hh, hh * k, k)
    x_el = image_size * image_size * channels
    # sigmoid (read the logit image, write x_hat), then the loss and its
    # gradient (read x_hat and the target, write x_hat's gradient) and the
    # head's cross-entropy (logits in, their gradient out)
    ops.append(Op("sigmoid", 0.0, 2 * rows * x_el * b))
    ops.append(Op("loss", 0.0, rows * (3 * x_el * b + 2 * k * 4)))
    ops.append(Op("adam", 0.0,
                  configs * param_count(m, image_size, channels) * 7 * 4))
    return ops
