"""The plain reference of the reference notebook's supervised autoencoder and
latent MLP, in float32 PyTorch with TF32 and cuDNN off.

It follows the notebook's modules (Report.md:287-433 of
MatteoGiuseppetti/Hybrid-Autoencoder-MLP-Pipeline-for-Satellite-Image-
Classification) and imports nothing of the program under test: its
parameters are a dict keyed by the notebook's ``state_dict`` names, with
PyTorch's layouts (conv OIHW, transposed conv (in, out, kh, kw), linear
(out, in)); images are uint8 NHWC, as the program takes them.

Every convolution and linear goes through :func:`mm_op`, which rounds both
operands (and, in the backward, the incoming gradient) with a rounding
function ``q``: the identity for the reference itself, a lower precision
for the control (portbench.reference.precision).

Departures from the notebook, each one the program's own: the training
augmentation's draws (flip, crop offsets, noise) come from a
``torch.Generator`` in the order :func:`draw_stacked` freezes; Adam is the
classic one with eps after the square root of the bias-corrected second
moment (the JAX package's order of operations).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class no_tf32:
    """Plain float32 arithmetic on the card, restored on exit: both TF32
    switches off, and cuDNN off, so that every convolution runs PyTorch's
    own im2col and float32 GEMM in place of an algorithm cuDNN picks by
    heuristics (some of which, FFT and Winograd ones, round far more
    than float32 does)."""

    def __enter__(self):
        cudnn = torch.backends.cudnn
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      cudnn.enabled, cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        cudnn.enabled, cudnn.allow_tf32 = False, False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.enabled,
         torch.backends.cudnn.allow_tf32) = self.saved


# ---- parameters ------------------------------------------------------------

def ae_shapes(m: dict, image_size: int, channels: int
              ) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every supervised-AE tensor in ``state_dict``
    order; kind is the init rule: ``w:<fan>`` / ``b:<fan>`` (uniform with
    bound 1/sqrt(fan)), ``bn_w``, ``bn_b``, ``bn_mean``, ``bn_var``,
    ``count``."""
    enc = [channels] + list(m["encoder_channels"])
    n = len(enc) - 1
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def bn(prefix, c):
        out.extend([(f"{prefix}.weight", (c,), "bn_w"),
                    (f"{prefix}.bias", (c,), "bn_b"),
                    (f"{prefix}.running_mean", (c,), "bn_mean"),
                    (f"{prefix}.running_var", (c,), "bn_var"),
                    (f"{prefix}.num_batches_tracked", (), "count")])

    for i in range(n):
        fan = enc[i] * 9
        out += [(f"enc.encoder.{3 * i}.weight", (enc[i + 1], enc[i], 3, 3),
                 f"w:{fan}"),
                (f"enc.encoder.{3 * i}.bias", (enc[i + 1],), f"b:{fan}")]
        bn(f"enc.encoder.{3 * i + 1}", enc[i + 1])
    s = image_size // 2 ** n
    feat = enc[-1] * s * s
    lat = m["latent_dim"]
    out += [(f"enc.encoder.{3 * n + 1}.weight", (lat, feat), f"w:{feat}"),
            (f"enc.encoder.{3 * n + 1}.bias", (lat,), f"b:{feat}"),
            ("dec.decoder_input.weight", (feat, lat), f"w:{lat}"),
            ("dec.decoder_input.bias", (feat,), f"b:{lat}")]
    rev = list(reversed(m["encoder_channels"])) + [channels]
    for i in range(n):
        fan = rev[i + 1] * 9  # a transposed conv's fan is out * k * k
        out += [(f"dec.decoder.{3 * i + 1}.weight", (rev[i], rev[i + 1], 3, 3),
                 f"w:{fan}"),
                (f"dec.decoder.{3 * i + 1}.bias", (rev[i + 1],), f"b:{fan}")]
        if i < n - 1:
            bn(f"dec.decoder.{3 * i + 2}", rev[i + 1])
    hh, k = m["head_hidden"], m["num_classes"]
    out += [("classifier.0.weight", (hh, lat), f"w:{lat}"),
            ("classifier.0.bias", (hh,), f"b:{lat}"),
            ("classifier.2.weight", (k, hh), f"w:{hh}"),
            ("classifier.2.bias", (k,), f"b:{hh}")]
    return out


def mlp_shapes(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """The latent MLP's tensors: Linear + BatchNorm1d + ReLU (+ Dropout after
    the first) per hidden width, then the output Linear (``net.{0,1,4,5,7}``
    for two hidden layers)."""
    dims = [m["latent_dim"]] + list(m["mlp_hidden"])
    out: List[Tuple[str, Tuple[int, ...], str]] = []
    idx = 0
    for i in range(len(m["mlp_hidden"])):
        fan = dims[i]
        out += [(f"net.{idx}.weight", (dims[i + 1], fan), f"w:{fan}"),
                (f"net.{idx}.bias", (dims[i + 1],), f"b:{fan}")]
        for key, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                          ("running_mean", "bn_mean"),
                          ("running_var", "bn_var")):
            out.append((f"net.{idx + 1}.{key}", (dims[i + 1],), kind))
        out.append((f"net.{idx + 1}.num_batches_tracked", (), "count"))
        idx += 4 if i == 0 else 3
    out += [(f"net.{idx}.weight", (m["num_classes"], dims[-1]),
             f"w:{dims[-1]}"),
            (f"net.{idx}.bias", (m["num_classes"],), f"b:{dims[-1]}")]
    return out


def trainable(shapes) -> List[str]:
    """The names of the trainable tensors, in ``named_parameters`` order."""
    return [name for name, _, kind in shapes
            if kind.split(":")[0] in ("w", "b", "bn_w", "bn_b")]


# ---- rounded products ------------------------------------------------------

class _Rounded(torch.autograd.Function):
    """op(q(x), q(w)) with the backward's products on q(x), q(w) and q(dy):
    every product of the forward and the backward sees operands in the
    precision ``q`` keeps."""

    @staticmethod
    def forward(ctx, x, w, op, q):
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq)
        ctx.op, ctx.q = op, q
        return op(xq, wq)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        with torch.enable_grad():
            x_ = xq.detach().requires_grad_(ctx.needs_input_grad[0])
            w_ = wq.detach().requires_grad_(True)
            y = ctx.op(x_, w_)
            wanted = [t for t in (x_, w_) if t.requires_grad]
            grads = torch.autograd.grad(y, wanted, ctx.q(dy))
        gx = grads[0] if ctx.needs_input_grad[0] else None
        return gx, grads[-1], None, None


def mm_op(op, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          q: Round) -> torch.Tensor:
    """op(x, w) + b with op's operands rounded by ``q`` (the identity: the
    plain product)."""
    if q is identity:
        y = op(x, w)
    else:
        y = _Rounded.apply(x, w, op, q)
    shape = (1, -1) + (1,) * (y.dim() - 2)
    return y + b.reshape(shape)


def _conv(x, w):
    return F.conv2d(x, w, stride=2, padding=1)


def _convt(x, w):
    return F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)


def _linear(x, w):
    return x @ w.t()


def _bn_eval(x, p, prefix, eps):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    r = lambda k: p[f"{prefix}.{k}"].reshape(shape)
    return (x - r("running_mean")) / torch.sqrt(r("running_var") + eps) \
        * r("weight") + r("bias")


def _bn_train(x, p, prefix, eps):
    """Batch statistics, the biased variance, gradients through both."""
    dims = [0] + list(range(2, x.dim()))
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) / torch.sqrt(var + eps) \
        * p[f"{prefix}.weight"].reshape(shape) \
        + p[f"{prefix}.bias"].reshape(shape)


# ---- forwards --------------------------------------------------------------

def encoder(p: Params, x: torch.Tensor, m: dict, train: bool = False,
            q: Round = identity,
            stats: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
            ) -> torch.Tensor:
    """x float NCHW in [0, 1] -> latents (N, latent). ``stats``, a list,
    collects each BatchNorm input's per-channel mean and biased variance."""
    n = len(m["encoder_channels"])
    h = x
    for i in range(n):
        h = mm_op(_conv, h, p[f"enc.encoder.{3 * i}.weight"],
                  p[f"enc.encoder.{3 * i}.bias"], q)
        if stats is not None:
            stats.append((h.mean((0, 2, 3)), h.var((0, 2, 3),
                                                   unbiased=False)))
        bn = _bn_train if train else _bn_eval
        h = torch.relu(bn(h, p, f"enc.encoder.{3 * i + 1}", m["bn_eps"]))
    return mm_op(_linear, h.flatten(1), p[f"enc.encoder.{3 * n + 1}.weight"],
                 p[f"enc.encoder.{3 * n + 1}.bias"], q)


def decoder(p: Params, z: torch.Tensor, m: dict, image_size: int,
            train: bool = False, q: Round = identity) -> torch.Tensor:
    """latents -> x_hat NCHW in [0, 1]."""
    chans = list(m["encoder_channels"])
    n = len(chans)
    s = image_size // 2 ** n
    h = mm_op(_linear, z, p["dec.decoder_input.weight"],
              p["dec.decoder_input.bias"], q)
    h = h.reshape(-1, chans[-1], s, s)
    for i in range(n):
        h = mm_op(_convt, h, p[f"dec.decoder.{3 * i + 1}.weight"],
                  p[f"dec.decoder.{3 * i + 1}.bias"], q)
        if i < n - 1:
            bn = _bn_train if train else _bn_eval
            h = torch.relu(bn(h, p, f"dec.decoder.{3 * i + 2}", m["bn_eps"]))
    return torch.sigmoid(h)


def head(p: Params, z: torch.Tensor, q: Round = identity) -> torch.Tensor:
    h = torch.relu(mm_op(_linear, z, p["classifier.0.weight"],
                         p["classifier.0.bias"], q))
    return mm_op(_linear, h, p["classifier.2.weight"], p["classifier.2.bias"],
                 q)


def mlp(p: Params, z: torch.Tensor, m: dict, q: Round = identity,
        stats: Optional[list] = None) -> torch.Tensor:
    """Eval-mode latent MLP (dropout is the identity) -> logits."""
    h = z
    idx = 0
    for i in range(len(m["mlp_hidden"])):
        h = mm_op(_linear, h, p[f"net.{idx}.weight"], p[f"net.{idx}.bias"], q)
        if stats is not None:
            stats.append((h.mean(0), h.var(0, unbiased=False)))
        h = torch.relu(_bn_eval(h, p, f"net.{idx + 1}", m["bn_eps"]))
        idx += 4 if i == 0 else 3
    return mm_op(_linear, h, p[f"net.{idx}.weight"], p[f"net.{idx}.bias"], q)


def to_nchw(imgs_u8: torch.Tensor) -> torch.Tensor:
    return imgs_u8.permute(0, 3, 1, 2).float() / 255.0


@torch.no_grad()
def serve_logits(ae: Params, head_mlp: Params, imgs_u8: torch.Tensor,
                 m: dict, q: Round = identity,
                 block: int = 4096) -> torch.Tensor:
    """uint8 NHWC images -> the latent MLP's float32 logits (N, classes),
    computed in blocks of ``block`` rows on the images' device."""
    with no_tf32():
        outs = []
        for lo in range(0, len(imgs_u8), block):
            z = encoder(ae, to_nchw(imgs_u8[lo:lo + block]), m, q=q)
            outs.append(mlp(head_mlp, z, m, q=q))
        return torch.cat(outs)


# ---- training --------------------------------------------------------------

def draw_stacked(c: int, n: int, image_size: int, channels: int,
                 crop_padding: int, gen: torch.Generator, device,
                 dtype: torch.dtype):
    """The draws of one step of ``c`` configs on a shared batch: flips
    (c, n, 1), offsets (c, n, 2), noise (c, n, H, W, ch)."""
    flip = torch.rand((c, n, 1), generator=gen, device=device) < 0.5
    off = torch.randint(0, 2 * crop_padding + 1, (c, n, 2), generator=gen,
                        device=device)
    noise = torch.randn((c, n, image_size, image_size, channels),
                        generator=gen, device=device, dtype=dtype)
    return flip, off, noise


def augment(imgs_u8: torch.Tensor, flip: torch.Tensor, off: torch.Tensor,
            noise: torch.Tensor, crop_padding: int,
            noise_std: float) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW: scale to [0, 1], zero-pad, mirror the
    padded image where ``flip``, crop the image size at ``off`` (row,
    column), add ``noise_std`` * noise."""
    x = to_nchw(imgs_u8)
    n, _, h, w = x.shape
    p = crop_padding
    padded = F.pad(x, (p, p, p, p))
    padded = torch.where(flip.reshape(n, 1, 1, 1), padded.flip(3), padded)
    rows = off[:, 0:1] + torch.arange(h, device=x.device)
    cols = off[:, 1:2] + torch.arange(w, device=x.device)
    idx = torch.arange(n, device=x.device)[:, None, None, None]
    ch = torch.arange(x.shape[1], device=x.device)[None, :, None, None]
    out = padded[idx, ch, rows[:, None, :, None], cols[:, None, None, :]]
    return out + noise_std * noise.float().permute(0, 3, 1, 2)


def ae_loss(p: Params, x: torch.Tensor, labels: torch.Tensor, alpha: float,
            m: dict, image_size: int, q: Round = identity) -> torch.Tensor:
    """alpha * mean squared error of the reconstruction against the
    augmented input + mean cross-entropy of the internal head."""
    z = encoder(p, x, m, train=True, q=q)
    x_hat = decoder(p, z, m, image_size, train=True, q=q)
    logits = head(p, z, q)
    mse = ((x_hat - x) ** 2).mean()
    ce = (torch.logsumexp(logits, -1)
          - logits.gather(-1, labels[:, None])[:, 0]).mean()
    return alpha * mse + ce


class Adam:
    """Classic Adam, in place on a dict of float32 tensors."""

    def __init__(self, params: Params):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params, lr: float) -> None:
        self.t += 1
        bc1 = 1.0 - BETA1 ** self.t
        bc2 = 1.0 - BETA2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(BETA1).add_((1 - BETA1) * g)
            self.v[k].mul_(BETA2).add_((1 - BETA2) * g * g)
            params[k].sub_(lr * (self.m[k] / bc1)
                           / (torch.sqrt(self.v[k] / bc2) + ADAM_EPS))


def train_steps(p0: Params, names: Sequence[str],
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor, tuple]],
                alpha: float, lr: float, m: dict, data: dict,
                q: Round = identity):
    """Steps of one config from ``p0`` (not changed) on ``batches`` of
    (uint8 images, labels, (flip, offsets, noise)): (losses, the first
    step's gradients, parameters after the last step), each by name."""
    with no_tf32():
        p = {k: v.detach().clone() for k, v in p0.items()}
        opt = Adam({k: p[k] for k in names})
        losses, g1 = [], None
        for imgs, labels, (flip, off, noise) in batches:
            x = augment(imgs, flip, off, noise, data["crop_padding"],
                        data["noise_std"])
            leaves = {k: p[k].detach().requires_grad_(True) for k in names}
            loss = ae_loss({**p, **leaves}, x, labels, alpha, m,
                           data["image_size"], q)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            grads = dict(zip(names, grads))
            if g1 is None:
                g1 = {k: v.detach().clone() for k, v in grads.items()}
            opt.step(p, grads, lr)
            losses.append(float(loss.detach()))
        return losses, g1, {k: p[k] for k in names}
