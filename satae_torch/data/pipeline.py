"""Subsample and split: the counterpart of satae/data/pipeline.py.

Same seeded numpy streams as satae, so the splits are byte-identical:
  * a per-class cap via a seeded permutation (``DataConfig.subsample_seed``);
  * a 70/15/15 permutation split with seed 42, sizes following
    torch.random_split's fraction semantics;
  * :func:`iter_batches`, host batches in a ``default_rng(seed + epoch)``
    order (the batch ``calibrate`` takes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from satae_torch.config import DataConfig
from satae_torch.data.ingest import RawDataset


@dataclass
class ArrayDataset:
    images: np.ndarray  # uint8 (N, H, W, 3)
    labels: np.ndarray  # int32 (N,)

    def __len__(self) -> int:
        return int(self.images.shape[0])


@dataclass
class Splits:
    train: ArrayDataset
    val: ArrayDataset
    test: ArrayDataset
    classes: Tuple[str, ...]


def subsample_per_class(labels: np.ndarray, per_class: int,
                        seed: int) -> np.ndarray:
    """Seeded per-class cap; returns sorted kept indices."""
    rng = np.random.default_rng(seed)
    keep = []
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        if len(idx) > per_class:
            idx = rng.permutation(idx)[:per_class]
        keep.append(idx)
    return np.sort(np.concatenate(keep))


def split_indices(n: int, fractions: Tuple[float, float, float],
                  seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded permutation split: floor each split, then hand the remainder
    out round-robin to the first splits (n=20001 -> 14001/3000/3000)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    sizes = [int(f * n) for f in fractions]
    for i in range(n - sum(sizes)):
        sizes[i % len(sizes)] += 1
    lo1, lo2 = sizes[0], sizes[0] + sizes[1]
    return perm[:lo1], perm[lo1:lo2], perm[lo2:lo2 + sizes[2]]


def make_splits(raw: RawDataset, cfg: DataConfig) -> Splits:
    keep = subsample_per_class(raw.labels, cfg.per_class, cfg.subsample_seed)
    images, labels = raw.images[keep], raw.labels[keep]
    tr, va, te = split_indices(len(images), cfg.split_fractions,
                               cfg.split_seed)
    mk = lambda idx: ArrayDataset(images[idx], labels[idx])
    return Splits(mk(tr), mk(va), mk(te), raw.classes)


def iter_batches(ds: ArrayDataset, batch_size: int, *, shuffle: bool,
                 seed: int = 0, epoch: int = 0, drop_remainder: bool = False
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(images, labels) batches of ``ds``, shuffled by
    ``default_rng(seed + epoch)``; the last batch may be short unless
    ``drop_remainder``."""
    n = len(ds)
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for lo in range(0, stop, batch_size):
        idx = order[lo:lo + batch_size]
        yield ds.images[idx], ds.labels[idx]


def num_batches(n: int, batch_size: int, drop_remainder: bool = False) -> int:
    return n // batch_size if drop_remainder else -(-n // batch_size)
