"""Roundings for the control: the reference computed one precision below the
one a configuration states.

* ``tf32``: float32's nearest lower step on this card, TF32 for float32
  with TF32 off: the operands of every product rounded to 10 mantissa bits
  (round to nearest, ties to even), products and sums in float32, as the
  tensor cores' TF32 mode computes.
* ``fp8_e4m3``: the step below bfloat16: each operand scaled per tensor so
  its largest magnitude meets e4m3's largest finite value (448), rounded to
  float8 e4m3, and scaled back.

Both are written out on the bits, so they round the same on the CPU and on
the card.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest TF32 value (ties to even)."""
    i = t.float().contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0x0FFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def round_fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the per-tensor scaled e4m3 value."""
    t = t.float()
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


# the control's rounding for each compute dtype a configuration states
BELOW = {"float32": ("tf32", round_tf32),
         "bfloat16": ("fp8_e4m3", round_fp8_e4m3)}
