"""Traffic kind ``serve_tile``: one caller classifies whole tiles with
``SatAEPipeline.predict``, back to back, each call waiting for its answer.

A tile is ``tile_images`` 64x64 uint8 patches held on the host (a
Sentinel-2 L1C tile of 10,980 px at 10 m cut into 171 x 171 patches), in
page-locked memory, as a loader that pins its batches (PyTorch's
``DataLoader(pin_memory=True)``) hands them on: the program's upload is
then the card's DMA read (40-46 GB/s on an H100 machine), not the host's
copy through a staging buffer, whose rate on that machine's shared host
went from 4.7 to 8.0 GB/s from one process to the next.
``tiles`` different tiles are made from the seed and sent in turn. A unit of
work is one ``predict`` call, upload and readback included.

Correctness: every answer of the window is judged. For each tile the
reference computes the float32 logits of every patch; a served class id's
gap is how far its reference logit lies below the reference's best, and the
number compared is the widest gap over every call (``logit_gap``). Random
models put some patches within rounding of a tie, so a sound run reads a
small gap and a lower precision a larger one.

``FAULTS``: the faults the check has to catch in this kind, planted in the
program by the tests of ``portbench/tests`` and by ``portbench/readings.py``
(the benchmark's own runs plant none): ``half_batch``, the encoder computes
the first half of each chunk's rows and the rest come out as zero latents;
``answer_altered``, one class id of each call changed where ``predict``
produces it. One chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

from typing import Dict, List, Tuple
from unittest import mock

import numpy as np
import torch

from satae_torch import api
from satae_torch import config as C
from satae_torch.api import SatAEPipeline
from satae_torch.models import fast_infer
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE

from portbench import inputs
from portbench import work as W
from portbench.reference import model as R


class Session:
    first_steps = 0  # units of work done before the window and judged

    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        m, d = cfg["model"], cfg["data"]
        self.m, self.size, self.ch = m, d["image_size"], d["channels"]
        self.n = tr["tile_images"]
        g = inputs.generator(cell.seed, dev, 1)
        self.tiles: List[np.ndarray] = []
        for _ in range(tr["tiles"]):
            t, _ = inputs.images(self.n, self.size, self.ch,
                                 m["num_classes"], g, dev)
            host = torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=dev.type == "cuda")
            host.copy_(t)
            self.tiles.append(host.numpy())  # the array keeps host alive
            if len(self.tiles) == 1:
                calib = t[:tr["calib_images"]].clone()
            del t
        self.ae, self.head = inputs.served_models(
            m, self.size, self.ch, calib, inputs.generator(cell.seed, dev, 2))
        del calib

        mc = C.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in m.items()})
        pc = C.PipelineConfig(
            data=C.DataConfig(image_size=self.size, channels=self.ch,
                              num_classes=m["num_classes"],
                              batch_size=d["batch_size"]),
            model=mc,
            runtime=C.RuntimeConfig(compute_dtype=cfg["compute_dtype"]))
        self.pipe = SatAEPipeline(pc, device=dev)
        ae = SupervisedAE(mc, self.ch, self.size)
        ae.load_state_dict(self.ae)
        mlp = MLP(mc)
        mlp.load_state_dict(self.head)
        self.pipe.ae, self.pipe.mlp = ae.to(dev).eval(), mlp.to(dev).eval()
        self.calls = 0
        self.answers: List[Tuple[int, np.ndarray]] = []
        self._ref = None
        for tile in self.tiles:  # every shape the window uses, built once
            self.pipe.predict(tile)

    # -- the window --------------------------------------------------------

    def unit(self) -> Dict[str, int]:
        i = self.calls % len(self.tiles)
        self.answers.append((i, self.pipe.predict(self.tiles[i])))
        self.calls += 1
        return {"calls": 1, "images": self.n}

    def work(self, peak) -> Dict[str, float]:
        """Per call: the model's forward FLOPs and the forward's least
        time, real rows only."""
        ops = W.serve_ops(self.m, self.size, self.ch,
                          self.cell.config["compute_dtype"], self.n)
        return {"flops": self.n * 2.0 * W.serve_forward_macs_per_image(
                    self.m, self.size, self.ch),
                "least_s": W.least_s(ops, peak)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.pipe = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def outputs(self):
        return self.answers

    def reference(self, q=R.identity) -> List[torch.Tensor]:
        """Each tile's logits, (n, classes) float32 on the host."""
        out = []
        for tile in self.tiles:
            x = torch.from_numpy(tile).to(self.cell.device)
            out.append(R.serve_logits(self.ae, self.head, x, self.m,
                                      q=q).cpu())
            del x
        return out

    def control_outputs(self, q):
        """The reference in the program's place at a lower precision: its
        class ids for every tile, as one call each."""
        return [(i, torch.argmax(lg, -1).numpy())
                for i, lg in enumerate(self.reference(q))]

    def compare(self, answers, limits) -> Tuple[Dict[str, float], int]:
        """({"logit_gap": widest gap}, calls judged wrong)."""
        if self._ref is None:
            self._ref = [lg.numpy() for lg in self.reference()]
        ref = self._ref
        best = [r.max(-1) for r in ref]
        widest, wrong = 0.0, 0
        for i, preds in answers:
            preds = np.asarray(preds).astype(np.int64)
            if preds.shape != (self.n,) or preds.min() < 0 \
                    or preds.max() >= ref[i].shape[1]:
                gap = float("inf")
            else:
                gap = float((best[i] - np.take_along_axis(
                    ref[i], preds[:, None], 1)[:, 0]).max())
            widest = max(widest, gap)
            wrong += gap > limits["logit_gap"]
        # answers that differ from the reference's best, in the first calls
        self.detail = {"calls": len(answers), "logit_gap": widest,
                       "differ": [int((np.asarray(p) != ref[i].argmax(-1))
                                      .sum()) for i, p in answers[:8]]}
        return {"logit_gap": widest}, wrong


def setup(cell) -> Session:
    return Session(cell)


def _half_batch():
    real = fast_infer.encoder_infer

    def half(fe, x):
        z = real(fe, x[: len(x) // 2])
        return torch.cat([z, torch.zeros_like(z[:1]).expand(
            len(x) - len(z), -1)])
    return mock.patch.object(fast_infer, "encoder_infer", half)


def _answer_altered():
    real = api.SatAEPipeline.predict_batched

    def altered(self, images):
        out = real(self, images)
        out[0] = (out[0] + 1) % self.config.model.num_classes
        return out
    return mock.patch.object(api.SatAEPipeline, "predict_batched", altered)


FAULTS = {"half_batch": _half_batch, "answer_altered": _answer_altered}
