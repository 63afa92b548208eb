"""The trainers' result contract: the counterpart of satae/train/loop.py's
``TrainResult`` and ``LogFn`` (loop.py:32-44). satae's per-batch engine is
not ported; the port trains through satae_torch.train.fast_loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

LogFn = Callable[[str], None]


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]    # best-epoch parameters, by name
    bn_state: Dict[str, torch.Tensor]  # best-epoch BatchNorm buffers
    best_val_loss: float
    best_val_acc: float
    best_epoch: int
    epochs_run: int
    history: Dict[str, List[float]]

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The best-epoch model as a state_dict (reference keys)."""
        return {**self.params, **self.bn_state}
