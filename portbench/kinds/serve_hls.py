"""Traffic kind ``serve_hls``: one caller classifies whole HLS tiles with a
ViT encoder (Prithvi-EO-1.0-100M's) and the pipeline's MLP through
``SatAEPipeline.predict``, back to back, each call waiting for its answer.

A tile is ``tile_chips`` chips of int16 reflectance (bands, frames, H, W),
Prithvi's layout, held on the host in page-locked memory as
``serve_tile`` holds its patches: an HLS tile of 3,660 px at 30 m cut into
16 x 16 chips of 224 px, 3 dates x 6 bands. ``tiles`` tiles are made from
the seed (:func:`hls_chips`) and sent in turn. A unit of work is one
``predict`` call, upload and readback included.

Weights: the encoder's from the seed with MAE's init
(portbench.reference.prithvi), the head's as ``serve_tile``'s (its
BatchNorm statistics those of ``calib_chips`` chips through the reference
encoder). The per-band constants are the mean and standard deviation of
the first tile's reflectance.

Correctness: every answer of the window is judged by ``logit_gap``, as in
``serve_tile``: for each tile the reference computes every chip's float32
logits (after the window, in blocks of chips), a served class id's gap is
how far its reference logit lies below the reference's best, and the number
compared is the widest over every call. ``latent_gap``: after the window
the program encodes each tile once (``encode``), and the number is the
worst relative L2 distance of a chip's latent from the reference's.

``FAULTS`` (planted by portbench/tests and portbench/readings.py, never by
the benchmark's runs): ``half_batch``, the encoder computes the first half
of each chunk's chips and the rest come out as zero latents;
``answer_altered``, one class id of each call changed where ``predict``
produces it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple
from unittest import mock

import numpy as np
import torch

from satae_torch import api
from satae_torch import config as C
from satae_torch.api import SatAEPipeline
from satae_torch.models import fast_infer

from portbench import inputs
from portbench import work_vit as WV
from portbench.reference import model as R
from portbench.reference import prithvi as P

VIT_KEYS = ("img_size", "patch_size", "num_frames", "tubelet_size",
            "in_chans", "embed_dim", "depth", "num_heads", "mlp_ratio",
            "norm_eps")


@torch.no_grad()
def hls_chips(n: int, m: dict, gen: torch.Generator, device,
              block: int = 16) -> torch.Tensor:
    """int16 reflectance chips (n, bands, frames, H, W) in [0, 10,000] on
    ``device``, ``block`` chips at a time: each chip a land-cover class of
    ten, whose per-band level and per-date change are the class's, with its
    own jitter, a stripe texture at its own angle, frequency and phase that
    moves the bands unequally, and pixel noise."""
    c, t, s = m["in_chans"], m["num_frames"], m["img_size"]
    labels = torch.randint(0, 10, (n,), generator=gen, device=device)
    level = torch.rand((10, c), generator=gen, device=device) * 5000 + 300
    season = torch.rand((10, 1, t), generator=gen, device=device) * 0.6 + 0.7
    weight = torch.rand((10, c), generator=gen, device=device) + 0.2
    ax = torch.arange(s, device=device, dtype=torch.float32)
    yy, xx = ax[:, None], ax[None, :]
    out = torch.empty((n, c, t, s, s), dtype=torch.int16, device=device)
    for lo in range(0, n, block):
        lab = labels[lo:lo + block]
        k = len(lab)
        per = torch.rand((k, 4), generator=gen, device=device)
        jitter = torch.randn((k, c, 1), generator=gen, device=device) * 300
        f = (per[:, 0] * 10 + 2)[:, None, None] * 2 * math.pi / s
        ang = per[:, 1, None, None] * math.pi
        wave = torch.sin(f * (yy * torch.cos(ang) + xx * torch.sin(ang))
                         + per[:, 2, None, None] * 2 * math.pi)
        amp = (per[:, 3] * 1500 + 200)[:, None] * weight[lab]  # (k, c)
        img = (level[lab][:, :, None] * season[lab] + jitter)[..., None,
                                                               None] \
            + amp[:, :, None, None, None] * wave[:, None, None]
        img = img + torch.randn((k, c, t, s, s), generator=gen,
                                device=device) * 150
        out[lo:lo + k] = img.clamp_(0, 10000).round_().to(torch.int16)
    return out


class Session:
    first_steps = 0  # units of work done before the window and judged

    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        self.m = {k: cfg["model"][k] for k in VIT_KEYS}
        self.mh = dict(cfg["head"])
        self.dtype = cfg["compute_dtype"]
        self.n = tr["tile_chips"]
        g = inputs.generator(cell.seed, dev, 1)
        self.tiles: List[np.ndarray] = []
        for _ in range(tr["tiles"]):
            t = hls_chips(self.n, self.m, g, dev)
            host = torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=dev.type == "cuda")
            host.copy_(t)
            self.tiles.append(host.numpy())  # the array keeps host alive
            if len(self.tiles) == 1:
                calib = t[:tr["calib_chips"]].clone()
                x = t.double().transpose(0, 1).reshape(t.shape[1], -1)
                self.mean = tuple(float(v) for v in x.mean(1))
                self.std = tuple(float(v) for v in x.std(1))
                del x
            del t
        self.enc = P.init_params(self.m, inputs.generator(cell.seed, dev, 2),
                                 dev)
        self.head = self._head(calib, inputs.generator(cell.seed, dev, 3))
        del calib

        vc = C.ViTConfig(**self.m, band_mean=self.mean, band_std=self.std)
        mc = C.ModelConfig(latent_dim=self.mh["latent_dim"],
                           mlp_hidden=tuple(self.mh["mlp_hidden"]),
                           mlp_dropout=self.mh["mlp_dropout"],
                           num_classes=self.mh["num_classes"],
                           bn_momentum=self.mh["bn_momentum"],
                           bn_eps=self.mh["bn_eps"])
        pc = C.PipelineConfig(
            data=C.DataConfig(batch_size=cfg["data"]["batch_size"],
                              num_classes=self.mh["num_classes"]),
            model=mc, runtime=C.RuntimeConfig(compute_dtype=self.dtype))
        self.pipe = SatAEPipeline(pc, device=dev, encoder=vc).load_torch(
            self.enc, self.head)
        self.calls = 0
        self.answers: List[Tuple[int, np.ndarray]] = []
        self.latents: List[np.ndarray] = []
        self._ref = None
        for tile in self.tiles:  # every shape the window uses, built once
            self.pipe.predict(tile)

    @torch.no_grad()
    def _head(self, calib: torch.Tensor, gen: torch.Generator):
        """The MLP head as ``inputs.served_models`` makes one: weights from
        ``gen``, BatchNorm scales in [0.5, 1.5) and shifts in [-0.2, 0.2),
        the running statistics those of the calibration chips' reference
        latents flowing through the layers before them."""
        dev = calib.device
        head = inputs.tensors(R.mlp_shapes(self.mh), gen, dev)
        for name in [k for k in head if k.endswith("running_mean")]:
            pre = name[:-len("running_mean")]
            c = head[name].numel()
            head[pre + "weight"] = torch.rand(c, generator=gen,
                                              device=dev) + 0.5
            head[pre + "bias"] = (torch.rand(c, generator=gen,
                                             device=dev) - 0.5) * 0.4
        with R.no_tf32():
            z = torch.cat([P.latents(self.enc, self.m, calib[lo:lo + 16],
                                     self.mean, self.std)
                           for lo in range(0, len(calib), 16)])
        prefixes, idx = [], 1
        for i in range(len(self.mh["mlp_hidden"])):
            prefixes.append(f"net.{idx}")
            idx += 4 if i == 0 else 3
        inputs._fill_stats(head, prefixes,
                           lambda st: R.mlp(head, z, self.mh, stats=st))
        return head

    # -- the window --------------------------------------------------------

    def unit(self) -> Dict[str, int]:
        i = self.calls % len(self.tiles)
        self.answers.append((i, self.pipe.predict(self.tiles[i])))
        self.calls += 1
        return {"calls": 1, "images": self.n}

    def work(self, peak) -> Dict[str, float]:
        """Per call: the forward's FLOPs and least time, and the least time
        of its attention, LayerNorm and K1 work (portbench.work_vit)."""
        return WV.work(self.m, self.mh, self.dtype, self.n, peak)

    def release(self) -> None:
        """One ``encode`` of each tile for ``latent_gap``, then free the
        program's state before the reference runs."""
        self.latents = [self.pipe.encode(t) for t in self.tiles]
        self.pipe = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def outputs(self):
        return self.answers, self.latents

    def reference(self, q=R.identity):
        """Each tile's (latents, logits), float32 on the host."""
        out = []
        for tile in self.tiles:
            x = torch.from_numpy(tile).to(self.cell.device)
            z, lg = P.serve_logits(self.enc, self.head, x, self.m, self.mh,
                                   self.mean, self.std, q=q)
            out.append((z.cpu(), lg.cpu()))
            del x
        return out

    def control_outputs(self, q):
        """The reference in the program's place at a lower precision: its
        class ids for every tile, as one call each, and its latents."""
        ref = self.reference(q)
        return ([(i, torch.argmax(lg, -1).numpy())
                 for i, (_, lg) in enumerate(ref)],
                [z.numpy() for z, _ in ref])

    def compare(self, outputs, limits) -> Tuple[Dict[str, float], int]:
        """({"logit_gap": widest gap, "latent_gap": worst relative L2},
        calls judged wrong)."""
        answers, latents = outputs
        if self._ref is None:
            self._ref = [(z.numpy(), lg.numpy()) for z, lg in
                         self.reference()]
        ref = [lg for _, lg in self._ref]
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
        lat = 0.0
        for (zr, _), z in zip(self._ref, latents):
            z = np.asarray(z, np.float64)
            if z.shape != zr.shape or not np.isfinite(z).all():
                lat = float("inf")
                continue
            lat = max(lat, float((np.linalg.norm(z - zr, axis=1)
                                  / np.linalg.norm(zr, axis=1)).max()))
        if len(latents) != len(self._ref):
            lat = float("inf")
        wrong += lat > limits["latent_gap"]
        self.detail = {"calls": len(answers), "logit_gap": widest,
                       "latent_gap": lat,
                       "differ": [int((np.asarray(p) != ref[i].argmax(-1))
                                      .sum()) for i, p in answers[:8]]}
        return {"logit_gap": widest, "latent_gap": lat}, wrong


def setup(cell) -> Session:
    return Session(cell)


def _half_batch():
    real = fast_infer.vit_encoder_infer

    def half(fv, x):
        z = real(fv, x[: len(x) // 2])
        return torch.cat([z, torch.zeros_like(z[:1]).expand(
            len(x) - len(z), -1)])
    return mock.patch.object(fast_infer, "vit_encoder_infer", half)


def _answer_altered():
    real = api.SatAEPipeline.predict_batched

    def altered(self, images):
        out = real(self, images)
        out[0] = (out[0] + 1) % self.config.model.num_classes
        return out
    return mock.patch.object(api.SatAEPipeline, "predict_batched", altered)


FAULTS = {"half_batch": _half_batch, "answer_altered": _answer_altered}
