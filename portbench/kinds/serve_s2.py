"""Traffic kind ``serve_s2``: one caller classifies whole Sentinel-2 L1C
tiles with a Swin Transformer V2 encoder (SatlasPretrain's Sentinel-2
Swin-v2-B) and the pipeline's MLP through ``SatAEPipeline.predict``, back
to back, each call waiting for its answer.

A tile is ``tile_chips`` chips of int16 digital numbers (bands, H, W),
Satlas's 9-band layout (the TCI's B04, B03, B02 as 8-bit values, then B05,
B06, B07, B08, B11, B12 as 16-bit ones), held on the host in page-locked
memory as ``serve_hls`` holds its chips: the 10,752-px core of a 10,980-px
MGRS tile cut into 21 x 21 chips of 512 px. ``tiles`` tiles are made from
the seed (:func:`s2_chips`) and sent in turn. A unit of work is one
``predict`` call, upload and readback included.

Weights: the encoder's from the seed with torchvision's init
(portbench.reference.satlas_swin), the head's as ``serve_hls`` makes them
(its BatchNorm statistics those of ``calib_chips`` chips through the
reference encoder).

Correctness, as in ``serve_hls`` (whose Session this kind extends):
``logit_gap`` on every answer of the window, how far a served class id's
float32 reference logit lies below the reference's best, the widest over
every call; ``latent_gap``, after the window one ``encode`` of each tile,
the worst relative L2 distance of a chip's latent from the reference's.

``FAULTS`` (planted by portbench/tests and portbench/readings.py, never by
the benchmark's runs): ``half_batch``, the encoder computes the first half
of each chunk's chips and the rest come out as zero latents;
``answer_altered``, one class id of each call changed where ``predict``
produces it, to the class the program's own logits rank last for that chip.
``serve_hls``'s fault of that name moves the chip to the next class
instead, which this cell's check misses where that class is within the
sound runs' gap of the best (PERF.md section 2).
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
from portbench import work_swin as WS
from portbench.kinds import serve_hls
from portbench.reference import model as R
from portbench.reference import satlas_swin as S

SWIN_KEYS = ("img_size", "patch_size", "in_chans", "embed_dim", "depths",
             "num_heads", "window_size", "mlp_ratio", "norm_eps",
             "band_scale")
TCI_BANDS = 3  # the 8-bit bands first; the rest 16-bit


@torch.no_grad()
def s2_chips(n: int, m: dict, gen: torch.Generator, device,
             block: int = 16) -> torch.Tensor:
    """int16 digital-number chips (n, bands, H, W) on ``device``, ``block``
    chips at a time: the first TCI_BANDS bands in [0, 255], the others in
    [0, 16,000] (some above the 8,160 that the encoder's scale clips at);
    each chip a land-cover class of ten, whose per-band level is the
    class's, with its own jitter, a stripe texture at its own angle,
    frequency and phase that moves the bands unequally, and pixel noise."""
    c, s = m["in_chans"], m["img_size"]
    top = torch.tensor([255.0] * TCI_BANDS + [16000.0] * (c - TCI_BANDS),
                       device=device)
    unit = torch.ones(c, device=device)  # the 8-bit bands on their scale
    unit[:TCI_BANDS] = 255.0 / 9000.0
    labels = torch.randint(0, 10, (n,), generator=gen, device=device)
    level = (torch.rand((10, c), generator=gen, device=device) * 7000 + 300) \
        * unit
    weight = torch.rand((10, c), generator=gen, device=device) + 0.2
    ax = torch.arange(s, device=device, dtype=torch.float32)
    yy, xx = ax[:, None], ax[None, :]
    out = torch.empty((n, c, s, s), dtype=torch.int16, device=device)
    for lo in range(0, n, block):
        lab = labels[lo:lo + block]
        k = len(lab)
        per = torch.rand((k, 4), generator=gen, device=device)
        jitter = torch.randn((k, c), generator=gen, device=device) * 300 \
            * unit
        f = (per[:, 0] * 10 + 2)[:, None, None] * 2 * math.pi / s
        ang = per[:, 1, None, None] * math.pi
        wave = torch.sin(f * (yy * torch.cos(ang) + xx * torch.sin(ang))
                         + per[:, 2, None, None] * 2 * math.pi)
        amp = (per[:, 3] * 1500 + 200)[:, None] * weight[lab] * unit
        img = (level[lab] + jitter)[..., None, None] \
            + amp[:, :, None, None] * wave[:, None]
        img = img + torch.randn((k, c, s, s), generator=gen,
                                device=device) * (150 * unit)[:, None, None]
        img = torch.minimum(img.clamp_(min=0), top[:, None, None])
        out[lo:lo + k] = img.round_().to(torch.int16)
    return out


class Session(serve_hls.Session):
    """``serve_hls``'s session (the window's unit, the release and the
    check) on Sentinel-2 tiles and the Swin encoder."""

    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        self.m = {k: cfg["model"][k] for k in SWIN_KEYS}
        self.mh = dict(cfg["head"])
        self.dtype = cfg["compute_dtype"]
        self.n = tr["tile_chips"]
        # the program's configuration first: a program without the Swin
        # encoder fails here, before any input is made
        sc = C.SwinConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in self.m.items()})
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
        g = inputs.generator(cell.seed, dev, 1)
        self.tiles: List[np.ndarray] = []
        for _ in range(tr["tiles"]):
            t = s2_chips(self.n, self.m, g, dev)
            host = torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=dev.type == "cuda")
            host.copy_(t)
            self.tiles.append(host.numpy())  # the array keeps host alive
            if len(self.tiles) == 1:
                calib = t[:tr["calib_chips"]].clone()
            del t
        self.enc = S.init_params(self.m, inputs.generator(cell.seed, dev, 2),
                                 dev)
        self.head = self._head(calib, inputs.generator(cell.seed, dev, 3))
        del calib

        self.pipe = SatAEPipeline(pc, device=dev, encoder=sc).load_torch(
            self.enc, self.head)
        self.calls = 0
        self.answers: List[Tuple[int, np.ndarray]] = []
        self.latents: List[np.ndarray] = []
        self._ref = None
        for tile in self.tiles:  # every shape the window uses, built once
            self.pipe.predict(tile)

    @torch.no_grad()
    def _head(self, calib: torch.Tensor, gen: torch.Generator):
        """The MLP head as ``serve_hls`` makes one, its BatchNorm statistics
        those of the calibration chips' reference latents."""
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
            z = torch.cat([S.latents(self.enc, self.m, calib[lo:lo + 16])
                           for lo in range(0, len(calib), 16)])
        prefixes, idx = [], 1
        for i in range(len(self.mh["mlp_hidden"])):
            prefixes.append(f"net.{idx}")
            idx += 4 if i == 0 else 3
        inputs._fill_stats(head, prefixes,
                           lambda st: R.mlp(head, z, self.mh, stats=st))
        return head

    def work(self, peak) -> Dict[str, float]:
        """Per call: the forward's FLOPs and least time, and the least time
        of its window attention, LayerNorm and K1 work
        (portbench.work_swin)."""
        return WS.work(self.m, self.mh, self.dtype, self.n, peak)

    def reference(self, q=R.identity):
        """Each tile's (latents, logits), float32 on the host."""
        out = []
        for tile in self.tiles:
            x = torch.from_numpy(tile).to(self.cell.device)
            z, lg = S.serve_logits(self.enc, self.head, x, self.m, self.mh,
                                   q=q)
            out.append((z.cpu(), lg.cpu()))
            del x
        return out


def setup(cell) -> Session:
    return Session(cell)


def _half_batch():
    real = fast_infer.swin_encoder_infer

    def half(fs, x):
        z = real(fs, x[: len(x) // 2])
        return torch.cat([z, torch.zeros_like(z[:1]).expand(
            len(x) - len(z), -1)])
    return mock.patch.object(fast_infer, "swin_encoder_infer", half)


def _answer_altered():
    real = api.SatAEPipeline.predict_batched

    def altered(self, images):
        out = real(self, images)
        worst = np.argmin(self.predict_proba_batched(images[:1])[0])
        out[0] = int(worst)
        return out
    return mock.patch.object(api.SatAEPipeline, "predict_batched", altered)


FAULTS = {"half_batch": _half_batch, "answer_altered": _answer_altered}
