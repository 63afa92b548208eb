"""Sweep bookkeeping: the port's copy of satae/train/sweep_common.py, with
the same selection contract (reference C16/C22):

  * per-config results flush to a :class:`GridResultStore` (resumable);
  * cached configs are skipped on resume, but the global-best checkpoint of
    the earlier run competes with the configs trained now (else a resumed
    sweep would overwrite the winner with a worse model), and only when its
    meta carries the selection metric and every hp key (provenance notes
    such as ``{"reused": true}`` never compete);
  * the global best is checkpointed with its metric meta as soon as it is
    known, strictly before the config's result is flushed to the store;
  * if the winner lives only in the checkpoint, it is read back, so the
    returned model is the recorded winner; if every config diverged, the
    least-bad end-of-run model is returned and checkpointed with
    ``"diverged": true``.

The checkpoints are satae's: ``.msgpack`` trees in satae's layout with a
strict-JSON sidecar, so either package resumes the other's run directory.
A :class:`SweepBook` is given the carry-over of its model both ways
(``to_trees``: a :class:`TrainResult` -> satae's ``(params, bn_state)``;
``from_trees``: the trees -> the port's state_dict).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from satae_torch.io.checkpoint import GridResultStore, load_model, save_model
from satae_torch.train.loop import TrainResult
from satae_torch.utils.strict_json import json_restore

Trees = Tuple[Any, Any]
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def save_best_checkpoint(out_dir, name: str, params: Any, bn_state: Any,
                         hp: Dict[str, float], res: TrainResult,
                         diverged: bool = False) -> None:
    """Write ``<name>.msgpack`` (satae's trees) + strict-JSON meta carrying
    the selection metrics (resume protection reads them back)."""
    meta = {**hp, "best_val_loss": res.best_val_loss,
            "best_val_acc": res.best_val_acc, "best_epoch": res.best_epoch}
    if diverged:
        meta["diverged"] = True
    save_model(Path(out_dir) / f"{name}.msgpack", params, bn_state, meta=meta)


def _result_from_state_dict(sd: Dict[str, torch.Tensor],
                            best_val_loss: float, best_val_acc: float,
                            best_epoch: int) -> TrainResult:
    """A :class:`TrainResult` of a model read back from a checkpoint: its
    state_dict split into parameters and BatchNorm buffers; no epochs run,
    no history."""
    is_buf = lambda k: k.rsplit(".", 1)[-1] in _BUFFERS
    return TrainResult({k: v for k, v in sd.items() if not is_buf(k)},
                       {k: v for k, v in sd.items() if is_buf(k)},
                       best_val_loss, best_val_acc, best_epoch, 0, {})


class SweepBook:
    """Resume/selection bookkeeping of a sweep.

    mode="min" selects by ``best_val_loss`` (AE sweeps); mode="max" selects
    by ``best_val_acc`` (MLP sweeps). Both degrade the same way when every
    config's selection metric is non-finite: the least-bad end-of-run model
    is returned and checkpointed with a ``diverged`` marker.
    """

    def __init__(self, out_dir: Optional[str], *, ckpt_name: str,
                 store_name: str, mode: str, hp_keys: Tuple[str, ...],
                 to_trees: Callable[[TrainResult], Trees],
                 from_trees: Callable[[Any, Any], Dict[str, torch.Tensor]]):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.out_dir = out_dir
        self.ckpt_name = ckpt_name
        self.mode = mode
        self.hp_keys = hp_keys
        self.to_trees = to_trees
        self.from_trees = from_trees
        self.metric_key = "best_val_loss" if mode == "min" else "best_val_acc"
        self.store = GridResultStore(Path(out_dir) / store_name) \
            if out_dir else None
        self.results: Dict[str, Dict[str, float]] = {}
        self.best: Optional[TrainResult] = None
        self.best_hp: Dict[str, float] = {}
        self.fallback: Optional[TrainResult] = None
        self.fallback_hp: Dict[str, float] = {}
        self.fallback_key = float("inf")

        # resume protection: the earlier run's checkpoint competes only when
        # its meta carries the selection metric and every hp key; unreadable
        # meta counts as none
        self.ckpt_meta: Dict[str, float] = {}
        self.ckpt_metric = float("inf") if mode == "min" else -1.0
        if out_dir:
            meta_file = Path(out_dir) / f"{ckpt_name}.json"
            if meta_file.exists():
                try:
                    meta = json_restore(json.loads(meta_file.read_text()))
                except (json.JSONDecodeError, OSError):
                    meta = {}
                num = lambda v: isinstance(v, (int, float)) \
                    and not isinstance(v, bool)
                if (isinstance(meta, dict) and num(meta.get(self.metric_key))
                        and all(num(meta.get(k)) for k in hp_keys)):
                    self.ckpt_meta = meta
                    self.ckpt_metric = float(meta[self.metric_key])

    # -- per-config -------------------------------------------------------

    def better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def _metric(self, res: TrainResult) -> float:
        return res.best_val_loss if self.mode == "min" else res.best_val_acc

    def best_metric(self) -> float:
        """The value a candidate must beat to become the global best
        (the current best if any, else the resumed checkpoint's)."""
        if self.best is None:
            return self.ckpt_metric
        m = self._metric(self.best)
        return m if self.better(m, self.ckpt_metric) else self.ckpt_metric

    def cached(self, key: str) -> bool:
        """True (and the cached summary copied into results) when ``key``
        was already trained by an earlier run."""
        if self.store is not None and key in self.store:
            self.results[key] = self.store.results[key]
            return True
        return False

    def record(self, key: str, summary: Dict[str, float]) -> None:
        self.results[key] = summary
        if self.store is not None:
            self.store.record(key, summary)

    def offer(self, res: TrainResult, hp: Dict[str, float]) -> bool:
        """Consider a finished config for global best (checkpointing it) and
        for the all-diverged fallback. Returns True if it became the best."""
        is_best = self.better(self._metric(res), self.best_metric())
        if is_best:
            self.best, self.best_hp = res, hp
            if self.out_dir:
                save_best_checkpoint(self.out_dir, self.ckpt_name,
                                     *self.to_trees(res), hp, res)
        self.offer_fallback(res, hp)
        return is_best

    def offer_fallback(self, res: TrainResult, hp: Dict[str, float]) -> None:
        """Track the least-bad config for the all-diverged case. Symmetric
        across modes: min ranks by val loss, max by negated val acc; NaN
        metrics rank worst."""
        metric = res.best_val_loss if self.mode == "min" else \
            -res.best_val_acc
        cand = float(np.nan_to_num(metric, nan=np.inf))
        if self.fallback is None or cand < self.fallback_key:
            self.fallback, self.fallback_hp, self.fallback_key = \
                res, hp, cand

    # -- epilogue ---------------------------------------------------------

    def resolve(self, engine_name: str) -> Tuple[TrainResult,
                                                 Dict[str, float]]:
        """The winner: the best config trained now, else the resumed
        checkpoint (read back through ``from_trees``), else the all-diverged
        fallback (checkpointed with the ``diverged`` marker)."""
        ckpt_wins = self.best is None or \
            self.better(self.ckpt_metric, self._metric(self.best))
        if not ckpt_wins:
            return self.best, self.best_hp
        if not self.ckpt_meta:
            if self.fallback is not None:
                fb = self.fallback
                if self.out_dir:
                    save_best_checkpoint(self.out_dir, self.ckpt_name,
                                         *self.to_trees(fb),
                                         self.fallback_hp, fb, diverged=True)
                return fb, self.fallback_hp
            raise RuntimeError(
                f"{engine_name} produced no result and no prior checkpoint "
                "exists to resume from")
        params, bn_state = load_model(
            Path(self.out_dir) / f"{self.ckpt_name}.msgpack")
        hp = {k: float(self.ckpt_meta[k]) for k in self.hp_keys}
        loss = self.ckpt_metric if self.mode == "min" \
            else float(self.ckpt_meta.get("best_val_loss", float("inf")))
        acc = self.ckpt_metric if self.mode == "max" \
            else float(self.ckpt_meta.get("best_val_acc", 0.0))
        return _result_from_state_dict(
            self.from_trees(params, bn_state), loss, acc,
            int(self.ckpt_meta.get("best_epoch", -1))), hp
