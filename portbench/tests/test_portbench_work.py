"""The work counts and peaks of portbench/work.py against hand counts at the
notebook's shapes, and against the program's own arithmetic where it has
one (satae_torch/utils/roofline.py). CPU only."""

import json
import math
from pathlib import Path

import pytest

from portbench import work as W

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "portbench/configs/eurosat_sae_f32.json").read_text())
MODEL = M["model"]
H100 = "NVIDIA H100 80GB HBM3"


def test_peaks_are_the_data_sheet_dense_rates():
    assert W.peaks(H100, "float32") == {"flops": 495e12, "bytes": 3.35e12}
    assert W.peaks(H100, "bfloat16") == {"flops": 989e12, "bytes": 3.35e12}
    assert W.peaks("NVIDIA A100-SXM4-80GB", "float32") is None


def test_serving_forward_is_15_32_m_multiply_adds_an_image():
    # conv0 32x32 out x 32 x 27, conv1-3 4,718,592 each, the projection
    # 4096 x 64, the MLP 64x128 + 128x64 + 64x10
    hand = (32 * 32 * 32 * 27 + 3 * 4_718_592 + 4096 * 64
            + 64 * 128 + 128 * 64 + 64 * 10)
    assert hand == 15_319_680
    assert W.serve_forward_macs_per_image(MODEL, 64, 3) == hand


def test_train_flops_match_the_programs_roofline():
    from satae_torch.config import DataConfig, ModelConfig
    from satae_torch.utils import roofline

    ours = W.train_flops_per_image(MODEL, 64, 3)
    assert ours == roofline.train_flops_per_image(ModelConfig(), DataConfig(),
                                                  "model")
    assert ours == pytest.approx(181.9e6, rel=1e-3)


def test_param_count_is_the_models():
    from satae_torch.config import ModelConfig
    from satae_torch.models.supervised_ae import SupervisedAE

    n = sum(p.numel() for p in SupervisedAE(ModelConfig()).parameters())
    assert n == 1_316_045
    assert W.param_count(MODEL, 64, 3) == n


@pytest.mark.parametrize("dtype,batch,configs", [
    ("float32", 64, 45), ("bfloat16", 1024, 1), ("float32", 64, 1)])
def test_train_ops_sum_to_train_flops(dtype, batch, configs):
    ops = W.train_ops(MODEL, 64, 3, dtype, batch, configs)
    total = sum(op.flops for op in ops)
    assert total == pytest.approx(
        batch * configs * W.train_flops_per_image(MODEL, 64, 3), rel=1e-12)
    adam = [op for op in ops if op.name == "adam"][0]
    assert adam.bytes == configs * 1_316_045 * 7 * 4


def test_serving_chunk_bound_float32_512_rows():
    """A float32 chunk of 512 rows: ~312 MB of activations (uint8 in, every
    layer's input read and output written once in float32) and 2.6 MB of
    weights; its 15.7 GFLOP take 31.7 us at 495 TFLOP/s. Bytes bound every
    operation but conv3 (9.8 us of operations against 7.9 of bytes): 95.0
    us in all."""
    peak = W.peaks(H100, "float32")
    ops = W.serve_ops(MODEL, 64, 3, "float32", 512)
    act = 512 * 4 * (12288 / 4 + 12288 + 2 * (32768 + 16384 + 8192 + 4096)
                     + 12288 + 64 + 64 + 128 + 128 + 64 + 64 + 10)
    weights = 4 * (27 * 32 + 288 * 64 + 576 * 128 + 1152 * 256
                   + 2 * (32 + 64 + 128 + 256) + 4096 * 64 + 2 * 64
                   + 64 * 128 + 2 * 128 + 128 * 64 + 2 * 64 + 64 * 10
                   + 2 * 10)
    assert sum(op.bytes for op in ops) == pytest.approx(act + weights)
    assert sum(op.flops for op in ops) == 2 * 512 * 15_319_680
    assert W.least_s(ops, peak) == pytest.approx(95.04e-6, rel=1e-3)
    by_ops = [op.name for op in ops
              if op.flops / peak["flops"] > op.bytes / peak["bytes"]]
    assert by_ops == ["conv3"]


def test_serving_tile_bounds_by_dtype():
    """The whole 29,241-image tile: bf16 halves every activation but the
    uint8 input; the weights are read once a call."""
    f32 = W.least_s(W.serve_ops(MODEL, 64, 3, "float32", 29241),
                    W.peaks(H100, "float32"))
    bf16 = W.least_s(W.serve_ops(MODEL, 64, 3, "bfloat16", 29241),
                     W.peaks(H100, "bfloat16"))
    assert f32 == pytest.approx(5.403e-3, rel=1e-3)
    assert 0.5 * f32 < bf16 < 0.56 * f32
    assert math.isclose(W.serve_forward_macs_per_image(MODEL, 64, 3) * 2,
                        30.63936e6)
