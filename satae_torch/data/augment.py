"""Input transforms: the counterpart of satae/data/augment.py.

Only the val/test-time transform is ported so far; the training
augmentation (flip, pad-4 crop, noise) comes with the training slice
(ROADMAP.md §1 item 4).
"""

from __future__ import annotations

import torch


def normalize(imgs_u8: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (N,H,W,C) -> float [0,1], the same division as satae's."""
    return imgs_u8.to(dtype) / 255.0
