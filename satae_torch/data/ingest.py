"""Dataset loading: the counterpart of satae/data/ingest.py.

This slice ports the synthetic branch only. Real EuroSAT ingest (class-folder
trees, ``.zip`` archives, JPEG decode and the ``.npz`` decode cache) is a
later slice (ROADMAP.md §1 item 6): a set ``root`` or ``cache_dir`` raises
rather than being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from satae_torch.config import DataConfig
from satae_torch.data.synthetic import make_synthetic_eurosat


@dataclass
class RawDataset:
    """The decode-once arrays: everything downstream is numpy indexing."""

    images: np.ndarray  # uint8 (N, H, W, 3)
    labels: np.ndarray  # int32 (N,)
    classes: Tuple[str, ...]

    def __len__(self) -> int:
        return int(self.images.shape[0])


def load_dataset(cfg: DataConfig) -> RawDataset:
    """The synthetic stand-in for ``cfg`` (seeded by ``subsample_seed``, as
    in satae)."""
    if cfg.root or cfg.cache_dir:
        raise NotImplementedError(
            "satae_torch reads synthetic data only so far: folder/zip ingest "
            "and the decode cache are a later slice (ROADMAP.md §1 item 6)")
    images, labels, classes = make_synthetic_eurosat(
        per_class=cfg.per_class, image_size=cfg.image_size,
        seed=cfg.subsample_seed, difficulty=cfg.synthetic_difficulty)
    return RawDataset(images, labels, classes)
