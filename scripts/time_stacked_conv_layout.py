"""Time the vmap engine's stacked AE step (C = 45 configs, full width,
batch 64, TF32 off) with the config-folded activations handed to cuDNN's
grouped convolutions in NCHW memory and in channels-last memory (what
satae_torch.nn.stacked does), in turns, with cuDNN's deterministic
algorithms (fit's) and its defaults; then a profile of two channels-last
steps. Prints the card line first and writes chiprun_out/
stacked_layout.json.

Usage (one CUDA card): python3 scripts/time_stacked_conv_layout.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    from satae_torch.config import AETrainConfig, DataConfig, ModelConfig
    from satae_torch.kernels import _build
    from satae_torch.models.stacked import StackedSupervisedAE
    from satae_torch.nn import stacked as S
    from satae_torch.train.optim import adam_init
    from satae_torch.train.steps import stacked_ae_train_step

    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    grid = AETrainConfig()
    alphas = torch.tensor([a for a in grid.alphas
                           for _ in grid.learning_rates], device=dev)
    c = len(alphas)
    model = StackedSupervisedAE(ModelConfig(), c).init_configs(0).to(dev)
    opt = adam_init(list(model.parameters()))
    lrs = torch.full((c,), 1e-5, device=dev)
    imgs = torch.randint(0, 256, (64, 64, 64, 3), dtype=torch.uint8,
                         device=dev, generator=g)
    labels = torch.randint(0, 10, (64,), device=dev, generator=g)
    step = lambda: stacked_ae_train_step(model, opt, imgs, labels, alphas,
                                         lrs, DataConfig(), generator=g)
    channels_last = S._grouped

    def nchw(conv, x, w, b, **kw):
        """_grouped with x left in NCHW memory."""
        k = w.shape[0]
        return conv(x.contiguous(), w.reshape(k * w.shape[1], *w.shape[2:]),
                    b.reshape(-1), groups=k, **kw)

    out = {"card": card, "configs": c, "ms": {}}
    for det in (True, False):
        flags = torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                           deterministic=det,
                                           allow_tf32=False)
        with flags:
            turns = {"nchw": [], "channels_last": []}
            for name in ("nchw", "channels_last", "channels_last", "nchw"):
                S._grouped = nchw if name == "nchw" else channels_last
                step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    step()
                torch.cuda.synchronize()
                turns[name].append((time.perf_counter() - t0) / 5 * 1e3)
            S._grouped = channels_last
            wall, busy, events = chip_smoke.profile_device(
                lambda: [step() for _ in range(2)])
        key = "deterministic" if det else "default"
        out["ms"][key] = turns
        out[f"profile_{key}"] = dict(wall_ms=wall, device_ms=busy,
                                     top=chip_smoke.top_ops(events, 6))
        print(f"cuDNN {key}: a stacked AE step (C = {c}) NCHW "
              f"{turns['nchw']} ms, channels-last {turns['channels_last']}"
              f" ms (in turns); 2 channels-last steps profiled: wall "
              f"{wall:.2f} ms, device busy {busy:.2f} ms", flush=True)
        for t, count, name in chip_smoke.top_ops(events, 6):
            print(f"  {t:9.3f} ms  x{count:<4d} {name[:90]}", flush=True)
    dest = REPO / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "stacked_layout.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
