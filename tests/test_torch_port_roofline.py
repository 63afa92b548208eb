"""satae_torch/utils/roofline.py against satae/utils/roofline.py: the same
parameter count, FLOPs (both kinds) and HBM bytes for three configs, the
parameter count the port's model holds, and the H100 peaks of
``step_utilizations`` keyed by the card's name."""

import dataclasses

import pytest

from satae import config as JC
from satae.utils import roofline as jroof
from torch_port_threads import two_threads  # noqa: F401 (autouse)
from satae_torch import config as TC
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.utils import roofline as troof

CONFIGS = {
    "default": (JC.ModelConfig(), JC.DataConfig()),
    "narrow_32": (JC.ModelConfig(latent_dim=16,
                                 encoder_channels=(4, 8, 16, 16),
                                 mlp_hidden=(32, 16)),
                  JC.DataConfig(image_size=32)),
    "latent_128_two_layers": (JC.ModelConfig(latent_dim=128,
                                             encoder_channels=(8, 16),
                                             head_hidden=64),
                              JC.DataConfig(image_size=16, channels=3)),
}
H100 = "NVIDIA H100 80GB HBM3"


def _port(mc, dc):
    return (TC.ModelConfig(**dataclasses.asdict(mc)),
            TC.DataConfig(**{k: v for k, v in dataclasses.asdict(dc).items()
                             if k in {f.name for f in
                                      dataclasses.fields(TC.DataConfig)}}))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_roofline_model_is_satae_s(name):
    mc, dc = CONFIGS[name]
    tmc, tdc = _port(mc, dc)
    assert troof.param_count(tmc, tdc) == jroof.param_count(mc, dc)
    model = SupervisedAE(tmc, tdc.channels, tdc.image_size)
    assert troof.param_count(tmc, tdc) == sum(
        p.numel() for p in model.parameters())
    for kind in ("model", "executed"):
        assert troof.train_flops_per_image(tmc, tdc, kind) == \
            jroof.train_flops_per_image(mc, dc, kind)
    for b in (2, 4):
        assert troof.train_bytes_per_image(tmc, tdc, b) == \
            jroof.train_bytes_per_image(mc, dc, b)


def test_step_utilizations_on_the_h100():
    tmc, tdc = _port(*CONFIGS["default"])
    assert troof.step_utilizations(tmc, tdc, batch=64, step_seconds=0.02,
                                   dtype="f32", device_kind="TPU v5 lite") \
        == {}
    u = troof.step_utilizations(tmc, tdc, batch=64, step_seconds=0.02,
                                dtype="f32", device_kind=H100)
    flops = troof.train_flops_per_image(tmc, tdc, "model") * 64
    assert u["mfu"] == round(flops / 67e12 / 0.02, 4)
    assert u["flops_per_image_model"] == round(flops / 64)
    b = troof.train_bytes_per_image(tmc, tdc, 2)
    u16 = troof.step_utilizations(tmc, tdc, batch=1024, step_seconds=0.1,
                                  dtype="bf16", device_kind=H100)
    assert u16["hbm_bytes_per_step"] == round(
        b["total_ex_params"] * 1024 + b["params_opt_total"])
    assert u16["hbm_util"] == round(u16["hbm_bytes_per_step"] / 3.35e12 / 0.1,
                                    4)
