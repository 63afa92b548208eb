"""Inputs made from the seed, on the device, in a few large calls: images,
labels and the models' tensors. The program and the reference are handed
the same ones.

Images stand in for EuroSAT's 64x64x3 uint8 patches: each class has a
colour and a stripe frequency of its own, each image that colour with its
own jitter, a stripe pattern at its own angle and phase, and pixel noise,
so that the classes differ in first- and second-order statistics and the
logits of a random model spread. The numbers of images and their sizes
depend only on the cell, never on the seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference import model as R

Tensors = Dict[str, torch.Tensor]


def derived_seed(seed: int, stream: int) -> int:
    """The seed of one purpose (``stream``): every stream a seed of its
    own, so that adding a draw to one leaves the others as they were."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` seeded with :func:`derived_seed`."""
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, stream))


@torch.no_grad()
def images(n: int, image_size: int, channels: int, classes: int,
           gen: torch.Generator, device, block: int = 4096
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8 images (n, H, W, ch), int64 labels (n,)) on ``device``, made
    ``block`` images at a time so that the float temporaries stay small."""
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    colour = torch.rand((classes, channels), generator=gen,
                        device=device) * 160 + 40
    freq = torch.rand((classes,), generator=gen, device=device) * 6 + 1
    out = torch.empty((n, image_size, image_size, channels),
                      dtype=torch.uint8, device=device)
    ax = torch.arange(image_size, device=device, dtype=torch.float32)
    yy, xx = ax[:, None], ax[None, :]
    for lo in range(0, n, block):
        lab = labels[lo:lo + block]
        k = len(lab)
        per = torch.rand((k, 3), generator=gen, device=device)
        jitter = torch.randn((k, 1, 1, channels), generator=gen,
                             device=device) * 12
        amp = per[:, 0, None, None, None] * 50 + 10
        ang = per[:, 1, None, None] * math.pi
        phase = per[:, 2, None, None] * 2 * math.pi
        f = freq[lab][:, None, None] * 2 * math.pi / image_size
        wave = torch.sin(f * (yy * torch.cos(ang) + xx * torch.sin(ang))
                         + phase)[..., None]
        img = colour[lab][:, None, None, :] + jitter + amp * wave
        img = img + torch.randn((k, image_size, image_size, channels),
                                generator=gen, device=device) * 16
        out[lo:lo + k] = img.clamp_(0, 255).round_().to(torch.uint8)
    return out, labels


@torch.no_grad()
def tensors(shapes, gen: torch.Generator, device,
            configs: int = 0) -> Tensors:
    """Tensors for ``shapes`` (portbench.reference.model.ae_shapes /
    mlp_shapes) from one uniform draw: weights and biases uniform in
    +-1/sqrt(fan), BatchNorm scale 1 and shift 0, running mean 0 and
    variance 1. ``configs`` > 0 stacks that many configs on a leading
    axis."""
    lead = (configs,) if configs else ()
    sizes = [math.prod(lead + shape) for _, shape, kind in shapes
             if kind[:2] in ("w:", "b:")]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape, kind in shapes:
        full = lead + shape
        if kind[:2] in ("w:", "b:"):
            size = math.prod(full)
            bound = 1.0 / math.sqrt(int(kind[2:]))
            out[name] = (flat[at:at + size] * bound).reshape(full)
            at += size
        elif kind == "count":
            out[name] = torch.zeros(full, dtype=torch.long, device=device)
        else:
            fill = 1.0 if kind in ("bn_w", "bn_var") else 0.0
            out[name] = torch.full(full, fill, device=device)
    return out


@torch.no_grad()
def served_models(m: dict, image_size: int, channels: int,
                  calib_u8: torch.Tensor, gen: torch.Generator
                  ) -> Tuple[Tensors, Tensors]:
    """(autoencoder tensors, MLP tensors) of a served model: weights from
    ``gen``; BatchNorm scales in [0.5, 1.5) and shifts in [-0.2, 0.2); the
    running statistics those of ``calib_u8`` flowing through the layers
    before them, taken by the reference in float32, as a trained model's
    would be."""
    dev = calib_u8.device
    ae = tensors(R.ae_shapes(m, image_size, channels), gen, dev)
    head = tensors(R.mlp_shapes(m), gen, dev)
    for p in (ae, head):
        for name in [k for k in p if k.endswith("running_mean")]:
            pre = name[:-len("running_mean")]
            c = p[name].numel()
            p[pre + "weight"] = torch.rand(c, generator=gen,
                                           device=dev) + 0.5
            p[pre + "bias"] = (torch.rand(c, generator=gen,
                                          device=dev) - 0.5) * 0.4
    x = R.to_nchw(calib_u8)
    with R.no_tf32():
        _fill_stats(ae, [f"enc.encoder.{3 * i + 1}"
                         for i in range(len(m["encoder_channels"]))],
                    lambda st: R.encoder(ae, x, m, stats=st))
        z = R.encoder(ae, x, m)
        prefixes, idx = [], 1
        for i in range(len(m["mlp_hidden"])):
            prefixes.append(f"net.{idx}")
            idx += 4 if i == 0 else 3
        _fill_stats(head, prefixes, lambda st: R.mlp(head, z, m, stats=st))
    return ae, head


def _fill_stats(p: Tensors, prefixes: List[str], run) -> None:
    """Set each BatchNorm's running statistics, one layer at a time, to the
    batch's at its input with the layers before it already set: ``run(st)``
    runs the forward, appending each BatchNorm input's (mean, variance) to
    the list ``st``."""
    for k, prefix in enumerate(prefixes):
        st: List[Tuple[torch.Tensor, torch.Tensor]] = []
        run(st)
        p[f"{prefix}.running_mean"] = st[k][0].clone()
        p[f"{prefix}.running_var"] = st[k][1].clone()
