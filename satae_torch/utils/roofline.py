"""Analytic roofline accounting for the AE train step: the port's copy of
satae/utils/roofline.py, the same arithmetic over the same configs.

* :func:`train_flops_per_image` -- FLOPs of one train step per image.
  ``kind="model"`` counts the useful math of the reference architecture
  (dense conv taps; the transposed convs count as their forward-equivalent
  convs), the MFU numerator. ``kind="executed"`` counts satae's program
  as XLA lowers it: the decoder's k3/s2 transposed convs in satae's
  subpixel form (a stride-1 2x2 conv producing 4*C_out parity channels at
  the input's resolution, 16/9 x the useful taps) and the augmentation's
  selection matmuls. The port runs neither (``F.conv_transpose2d`` and an
  indexed crop), so on the card only ``kind="model"`` describes its work.

* :func:`train_bytes_per_image` -- satae's estimate of the HBM bytes one
  train step touches per image (activations and their gradients, BatchNorm
  moments, the subpixel rearrange, master parameters and Adam moments, the
  uint8 input); good to tens of percent, not exact.

Peaks by ``torch.cuda.get_device_name()``: one NVIDIA H100 (SXM data
sheet, dense): 989 TFLOP/s bf16 on tensor cores, 67 TFLOP/s float32 outside
them, 3.35 TB/s HBM, at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict

from satae_torch.config import DataConfig, ModelConfig

PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12}}
PEAK_HBM_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}


def param_count(mc: ModelConfig, dc: DataConfig) -> int:
    """Total supervised-AE parameters (conv/linear weights+biases, BN
    scale+bias): the parameter count of satae_torch.models.SupervisedAE,
    satae's ``supervised_ae_init`` leaf-size sum."""
    s = dc.image_size
    chans = (dc.channels,) + tuple(mc.encoder_channels)
    n = 0
    for cin, cout in zip(chans[:-1], chans[1:]):
        n += 9 * cin * cout + cout          # k3 conv w + b
        n += 2 * cout                       # BN scale + bias
    feat = (s // 2 ** len(mc.encoder_channels)) ** 2 * mc.encoder_channels[-1]
    n += feat * mc.latent_dim + mc.latent_dim              # encoder proj
    n += mc.latent_dim * feat + feat                       # decoder proj
    rev = tuple(reversed(mc.encoder_channels)) + (dc.channels,)
    for i, (cin, cout) in enumerate(zip(rev[:-1], rev[1:])):
        n += 9 * cin * cout + cout          # k3 transposed-conv w + b
        if i < len(rev) - 2:
            n += 2 * cout                   # BN on all but the output layer
    n += mc.latent_dim * mc.head_hidden + mc.head_hidden   # internal head
    n += mc.head_hidden * mc.num_classes + mc.num_classes
    return n


def _conv_macs(mc: ModelConfig, dc: DataConfig, executed: bool
               ) -> Dict[str, float]:
    """Forward MACs per image, by stage group."""
    s = dc.image_size
    chans = (dc.channels,) + tuple(mc.encoder_channels)
    enc = 0.0
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        out_sp = (s // 2 ** (i + 1)) ** 2
        enc += out_sp * cout * 9 * cin
    feat = (s // 2 ** len(mc.encoder_channels)) ** 2 * mc.encoder_channels[-1]
    proj = feat * mc.latent_dim * 2  # encoder + decoder projections
    head = mc.latent_dim * mc.head_hidden + mc.head_hidden * mc.num_classes
    dec = 0.0
    rev = tuple(reversed(mc.encoder_channels)) + (dc.channels,)
    in_sp = (s // 2 ** len(mc.encoder_channels)) ** 2
    for cin, cout in zip(rev[:-1], rev[1:]):
        # useful taps of the k3/s2 transposed conv = its forward-equivalent
        # conv (9*cin*cout per input pixel); the subpixel execution runs a
        # 2x2 conv producing 4*cout channels at input spatial = 16/9 x that
        dec += in_sp * cin * cout * (16 if executed else 9)
        in_sp *= 4
    # augmentation flip+crop one-hot selection matmuls (row+col), fwd only
    aug = 2 * s * s * s * dc.channels if executed else 0
    return {"encoder": enc, "decoder": dec, "proj": proj, "head": head,
            "aug": aug}


def train_flops_per_image(mc: ModelConfig, dc: DataConfig,
                          kind: str = "executed") -> float:
    """FLOPs (2/MAC) of one fused train step per image.

    Backward re-runs ~2x the forward matmul work (input-grad + weight-grad),
    except: augmentation is not differentiated (inputs are not params) and
    the first conv's input-grad is dead (its input is the augmented image).

    The deconv backward counts dense taps in both kinds: satae's subpixel
    deconv computes dL/dx as the dense k3/s2 adjoint conv and dL/dw as its
    native weight gradient (satae/nn/layers.py:171-192), so only the
    forward pays the subpixel 16/9 executed-tap factor.
    """
    m = _conv_macs(mc, dc, executed=(kind == "executed"))
    m_dense = _conv_macs(mc, dc, executed=False)
    s = dc.image_size
    conv0 = (s // 2) ** 2 * mc.encoder_channels[0] * 9 * dc.channels
    fwd = sum(m.values())
    bwd = 2 * (sum(m_dense.values()) - m_dense["aug"]) - conv0
    return 2.0 * (fwd + bwd)


def train_bytes_per_image(mc: ModelConfig, dc: DataConfig,
                          compute_dtype_bytes: int = 2) -> Dict[str, float]:
    """HBM bytes per image per train step, by term. Touch multipliers:

    - activations (block-boundary tensors in compute dtype): 3 touches
      (forward write, forward read by the consuming op, backward read for
      the weight grad) + 2 for the matching gradient tensor (write + read)
      + 1 extra read of each train-mode-BN'd conv output (the one-pass
      fused E[x^2]-E[x]^2 batch moments).
    - subpixel depth-to-space: the parity transpose materializes each
      decoder stage output once more (+2: write + read).
    - params (P total, f32 masters): master read 4P + compute-dtype cast
      (write 2P, fwd read 2P, bwd read 2P; for f32 compute the reads are
      4P each with no cast write) + f32 grads (write 4P + read 4P) + Adam
      m and v (read+write = 16P) + param write 4P.
    - input: uint8 batch read once.
    """
    b = compute_dtype_bytes
    s = dc.image_size
    sq = s * s
    x_el = sq * dc.channels
    enc_outs = [(s // 2 ** (i + 1)) ** 2 * c
                for i, c in enumerate(mc.encoder_channels)]
    dec_outs = list(reversed(enc_outs[:-1])) + [x_el]
    small = (2 * mc.latent_dim + enc_outs[-1]  # z, head h1~latent, dec proj
             + mc.head_hidden + mc.num_classes)
    act_el = x_el + sum(enc_outs) + sum(dec_outs) + small
    bn_el = sum(enc_outs) + sum(dec_outs[:-1])
    acts = (5 * act_el + bn_el + 2 * sum(dec_outs)) * b
    p = param_count(mc, dc)
    cast = (2 + 2 + 2) if b != 4 else (4 + 4)
    params = (4 + cast + 8 + 16 + 4) * p
    return {"activations": float(acts),
            "params_opt_per_image": 0.0,  # filled by caller: params / batch
            "params_opt_total": float(params),
            "input": float(x_el),
            "total_ex_params": float(acts + x_el)}


def step_utilizations(mc: ModelConfig, dc: DataConfig, *, batch: int,
                      step_seconds: float, dtype: str,
                      device_kind: str) -> Dict[str, float]:
    """MFU (model FLOPs), executed-FLOPs utilization, and HBM utilization
    of a measured step, or {} when the device's peaks are unknown.
    ``device_kind`` is ``torch.cuda.get_device_name()``, ``dtype`` "bf16"
    or "f32"."""
    peak_f = PEAK_FLOPS.get(device_kind, {}).get(dtype)
    peak_b = PEAK_HBM_BYTES.get(device_kind)
    if peak_f is None or peak_b is None:
        return {}
    bt = train_bytes_per_image(mc, dc, 2 if dtype == "bf16" else 4)
    bytes_step = bt["total_ex_params"] * batch + bt["params_opt_total"]
    flops_model = train_flops_per_image(mc, dc, "model") * batch
    flops_exec = train_flops_per_image(mc, dc, "executed") * batch
    return {
        "mfu": round(flops_model / peak_f / step_seconds, 4),
        "executed_flops_util": round(flops_exec / peak_f / step_seconds, 4),
        "hbm_util": round(bytes_step / peak_b / step_seconds, 4),
        "hbm_bytes_per_step": round(bytes_step),
        "flops_per_image_model": round(flops_model / batch),
        "flops_per_image_executed": round(flops_exec / batch),
    }
