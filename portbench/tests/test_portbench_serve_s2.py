"""The Sentinel-2 Swin serving cell on the CPU: its check driven through a
whole run at a small size (a sound run passes, each of the kind's
``FAULTS`` fails, the control at e4m3 fails), the work model's counts at
SatlasPretrain's Swin-v2-B widths against sums written out by hand, and
the readers of the cell's two new per-layer metrics on known spans. CPU
only."""

import math

import pytest
import torch

from portbench import run as RUN
from portbench import trace as T
from portbench import work as W
from portbench import work_swin as WS
from portbench.kinds import serve_hls, serve_s2
from portbench.reference import precision
from satae_torch.utils import profiling

CELL = "serve_s2.satlas_swinb_bf16"
SEED = 2 ** 31 + 211
NEW = ["wattn_ms_per_call.swin", "wattn_roofline_share.swin"]
SWIN = dict(img_size=512, patch_size=4, in_chans=9, embed_dim=128,
            depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32], window_size=8,
            mlp_ratio=4.0)
HEAD = dict(latent_dim=1024, mlp_hidden=[128, 64], num_classes=10)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(cell):
    """Two stages at 64 px (sides 16 and 8: the first shifted, the second
    its window and not), heads of 32, two chunks of 64 chips (the second
    ragged): the same code paths as the card's run."""
    cell.config["model"].update(img_size=64, embed_dim=32, depths=[2, 2],
                                num_heads=[1, 2])
    cell.config["head"].update(latent_dim=64, mlp_hidden=[16, 8])
    cell.traffic.update(tile_chips=100, calib_chips=8)


def test_sound_run_is_correct():
    r = RUN.run_cell(CELL, SEED, 0.2, False, "cpu", edit=small)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"logit_gap", "latent_gap"}
    assert set(r["metrics"]) >= {"setup_s", "serve_images_per_s",
                                 "serve_call_p95_ms"}


@pytest.mark.parametrize("fault", sorted(serve_s2.FAULTS))
def test_fault_is_caught(fault):
    with serve_s2.FAULTS[fault]():
        r = RUN.run_cell(CELL, SEED + 1, 0.2, False, "cpu", edit=small)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_answer_altered_is_caught_where_the_next_class_is_not():
    """On this seed the next class (serve_hls's fault) lies within the
    limit of the best, so that fault passes; this kind's fault, the chip's
    last class, fails the check."""
    with serve_hls._answer_altered():
        r = RUN.run_cell(CELL, SEED + 3, 0.2, False, "cpu", edit=small)
    assert r["correct"], r["checks"]
    with serve_s2.FAULTS["answer_altered"]():
        r = RUN.run_cell(CELL, SEED + 3, 0.2, False, "cpu", edit=small)
    assert not r["correct"], r["checks"]
    assert r["checks"]["logit_gap"]["value"] > \
        r["checks"]["logit_gap"]["limit"]


def test_control_at_e4m3_is_caught():
    r, session = RUN.run_cell(CELL, SEED + 2, 0.2, False, "cpu", edit=small,
                              keep=True)
    assert r["correct"], r["checks"]
    label, q = precision.BELOW["bfloat16"]
    assert label == "fp8_e4m3"
    limits = session.cell.limits
    numbers, wrong = session.compare(session.control_outputs(q), limits)
    assert wrong > 0
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def test_chips_are_int16_digital_numbers_and_differ():
    m = {"in_chans": 9, "img_size": 32}
    g = torch.Generator().manual_seed(5)
    x = serve_s2.s2_chips(10, m, g, "cpu", block=4)
    assert x.dtype == torch.int16 and x.shape == (10, 9, 32, 32)
    assert int(x.min()) >= 0
    assert int(x[:, :3].max()) <= 255  # the 8-bit TCI bands
    assert int(x[:, 3:].max()) <= 16000
    assert int(x[:, 3:].max()) > 8160  # some clip at the encoder's scale
    means = x.float().mean((2, 3))
    assert float(means.std(0).min()) > 1  # chips differ in every band
    again = serve_s2.s2_chips(10, m, torch.Generator().manual_seed(5), "cpu",
                              block=4)
    assert torch.equal(x, again)


def _hand_flops():
    """2 x multiply-adds a chip, written out: per block, a token's qkv (C x
    3C), proj (C x C), fc1 and fc2 (C x 4C each) = 12 C^2 multiply-adds,
    and its window attention 2 x 64 x C (q k over 64 keys, P v); per merge a
    merged token's 4C x 2C; the patch embedding 144 x 128 a token; the
    head 1,024 x 128 + 128 x 64 + 64 x 10."""
    macs = 128 * 128 * 144 * 128
    for i, depth in enumerate(SWIN["depths"]):
        c, t = 128 * 2 ** i, (128 // 2 ** i) ** 2
        macs += depth * t * (12 * c * c + 2 * 64 * c)
        if i < 3:
            macs += t // 4 * 4 * c * 2 * c
    return 2 * (macs + 1024 * 128 + 128 * 64 + 64 * 10)


def test_work_is_162_6_gflop_a_chip():
    ops = WS.ops(SWIN, HEAD, "bfloat16", 1)
    total = sum(op.flops for op in ops)
    assert total == _hand_flops()
    assert total / 1e9 == pytest.approx(162.605, abs=1e-3)
    by = lambda kind: [op for op in ops if WS.kind_of(op) == kind]
    assert len(by("wattn")) == 24 and len(by("ln")) == 1 + 48 + 3
    assert len(by("gemm")) == 1 + 24 * 4 + 3
    # the window attention: 4 x 64 x C a token a block
    assert sum(op.flops for op in by("wattn")) == sum(
        d * (128 // 2 ** i) ** 2 * 4 * 64 * 128 * 2 ** i
        for i, d in enumerate(SWIN["depths"]))


def test_window_attention_and_layernorm_bytes():
    ops = WS.ops(SWIN, HEAD, "bfloat16", 1)
    wattn = [op for op in ops if WS.kind_of(op) == "wattn"]
    # stage 1: 16,384 tokens, qkv (3 x 128) read and 128 written in bf16,
    # the 4 heads' 64 x 64 float32 bias tables and scales read
    assert wattn[0].bytes == 16384 * 4 * 128 * 2 + 4 * (64 * 64 + 1) * 4
    ln = [op for op in ops if WS.kind_of(op) == "ln"]
    # the embedding's norm reads and writes its rows; a post-norm reads the
    # branch and the stream and writes the stream; w and b float32
    assert ln[0].bytes == 16384 * 128 * 2 * 2 + 2 * 128 * 4
    assert ln[1].bytes == 16384 * 128 * 2 * 3 + 2 * 128 * 4


def test_least_time_of_a_tile():
    peak = W.peaks("NVIDIA H100 80GB HBM3", "bfloat16")
    w = WS.work(SWIN, HEAD, "bfloat16", 441, peak)
    assert w["flops"] == pytest.approx(441 * _hand_flops())
    assert w["flops"] / 1e12 == pytest.approx(71.709, abs=1e-3)
    assert w["least_s"] * 1e3 == pytest.approx(133.76, abs=0.01)
    assert w["gemm_least_s"] * 1e3 == pytest.approx(87.58, abs=0.01)
    assert w["wattn_least_s"] * 1e3 == pytest.approx(17.12, abs=0.01)
    assert w["ln_least_s"] * 1e3 == pytest.approx(27.75, abs=0.01)
    # stage 3's qkv at 441 chips: 2 x 1,024 tokens x 512 x 1,536, its least
    # time the larger of its operations' time at the bf16 peak and its
    # bytes' (activations in and out, the weight once) at 3.35 TB/s
    op = next(o for o in WS.ops(SWIN, HEAD, "bfloat16", 441)
              if o.name == "stage2.block0.qkv")
    flops = 2 * 441 * 1024 * 512 * 1536
    byts = (441 * 1024 * (512 + 1536) + 512 * 1536) * 2 + 1536 * 4
    assert op.least_s(peak) == pytest.approx(
        max(flops / 989e12, byts / 3.35e12))
    assert w["least_s"] > w["gemm_least_s"] + w["wattn_least_s"] \
        + w["ln_least_s"]


# ---- the per-layer readers on known spans ---------------------------------

S_NS = 1_000_000_000


def _rec(name, i, t0_s, device_ms):
    t0 = int(t0_s * S_NS)
    return profiling.SpanRecord(name, i, None, t0, t0 + 1000, {}, device_ms)


def _run(work):
    cell = RUN.Cell("c", {}, {}, 1, {}, 0)
    trace = T.Trace(window_s=1.0, busy_s=0.9, kernel_busy_s=0.5, kernels=10)
    units = [(10.0, 11.0, {}), (11.0, 12.0, {})]
    return RUN.Run(cell, 1.0, 1.0, units, work, None, trace, {"calls": 2})


def _read(name, run):
    return RUN._module("metrics", name).read(run)


def test_readers_from_known_spans(monkeypatch):
    recs = []
    for t0 in (10.2, 11.2):  # one call each: 3 window-attention spans
        i = int(t0 * 100)
        recs += [_rec("satae.wattn", i + j, t0 + 1e-3, 0.5 + j)
                 for j in range(3)]
    recs.append(_rec("satae.wattn", 1, 5.0, 100.0))  # before the window
    monkeypatch.setattr(profiling, "spans",
                        lambda: profiling.Spans(recs, 0))
    run = _run({"wattn_least_s": 1.5e-3})
    assert _read("wattn_ms_per_call.swin", run) == pytest.approx(4.5)
    assert _read("wattn_roofline_share.swin", run) == pytest.approx(
        100 * 1.5 / 4.5)


@pytest.mark.parametrize("name", NEW)
def test_readers_none_without_spans(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans",
                        lambda: profiling.Spans([], 0))
    run = _run({"wattn_least_s": 1e-3})
    assert _read(name, run) is None
    run.trace = None
    assert _read(name, run) is None


def test_manifest_lists_the_cell_and_its_metrics():
    man = RUN.load_manifest()
    per = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        assert per[name]["workloads"] == [CELL]
        assert per[name]["source"] == "program_span"
    traced = {m["name"] for m in RUN.metrics_of(CELL, True)}
    assert traced == set(NEW) | {"mfu.serve", "device_idle_share.serve",
                                 "kernels_roofline_share.serve",
                                 "k1_roofline_share.vit",
                                 "layernorm_roofline_share.vit"}
    assert {m["name"] for m in RUN.metrics_of(CELL, False)} == {
        "serve_images_per_s", "serve_call_p95_ms", "setup_s"}
    cell = {w["name"]: w for w in man["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "serve_s2"
    assert math.isclose(RUN.load_cell(CELL, 0).traffic["tile_chips"], 441)
