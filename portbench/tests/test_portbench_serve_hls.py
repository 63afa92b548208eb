"""The ViT serving cell on the CPU: its check driven through a whole run at a
small size (a sound run passes, each of the kind's ``FAULTS`` fails), the
work model's counts at Prithvi-EO-1.0-100M's widths, and the readers of the
cell's five per-layer metrics on known spans. CPU only."""

import pytest
import torch

from portbench import run as RUN
from portbench import trace as T
from portbench import work as W
from portbench import work_vit as WV
from portbench.kinds import serve_hls
from satae_torch.utils import profiling

CELL = "serve_hls.prithvi100m_bf16"
SEED = 2 ** 31 + 177
NEW = ["attn_ms_per_call.vit", "layernorm_ms_per_call.vit",
       "attn_roofline_share.vit", "layernorm_roofline_share.vit",
       "k1_roofline_share.vit"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(cell):
    """Tiny widths, two chunks of 64 chips (the second ragged): the same
    code paths as the card's run."""
    cell.config["model"].update(img_size=32, patch_size=8, num_frames=2,
                                embed_dim=64, depth=2, num_heads=2)
    cell.config["head"].update(latent_dim=64, mlp_hidden=[16, 8])
    cell.traffic.update(tile_chips=100, calib_chips=8)


def test_sound_run_is_correct():
    r = RUN.run_cell(CELL, SEED, 0.2, False, "cpu", edit=small)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"logit_gap", "latent_gap"}
    assert set(r["metrics"]) >= {"setup_s", "serve_images_per_s",
                                 "serve_call_p95_ms"}


@pytest.mark.parametrize("fault", sorted(serve_hls.FAULTS))
def test_fault_is_caught(fault):
    with serve_hls.FAULTS[fault]():
        r = RUN.run_cell(CELL, SEED + 1, 0.2, False, "cpu", edit=small)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_chips_are_int16_reflectance_and_differ():
    m = {"in_chans": 6, "num_frames": 3, "img_size": 32}
    g = torch.Generator().manual_seed(5)
    x = serve_hls.hls_chips(10, m, g, "cpu", block=4)
    assert x.dtype == torch.int16 and x.shape == (10, 6, 3, 32, 32)
    assert int(x.min()) >= 0 and int(x.max()) <= 10000
    means = x.float().mean((2, 3, 4))
    assert float(means.std(0).min()) > 10  # chips differ in every band
    again = serve_hls.hls_chips(10, m, torch.Generator().manual_seed(5),
                                "cpu", block=4)
    assert torch.equal(x, again)


PRITHVI = dict(img_size=224, patch_size=16, num_frames=3, tubelet_size=1,
               in_chans=6, embed_dim=768, depth=12, num_heads=12,
               mlp_ratio=4.0)
HEAD = dict(latent_dim=768, mlp_hidden=[128, 64], num_classes=10)


def test_work_is_114_23_gflop_a_chip():
    ops = WV.ops(PRITHVI, HEAD, "bfloat16", 1)
    gflop = sum(op.flops for op in ops) / 1e9
    assert gflop == pytest.approx(114.2294, abs=1e-4)
    by = lambda kind: [op for op in ops if WV.kind_of(op) == kind]
    # the GEMMs: patch 1.387, per block qkv 2.084, proj 0.695, fc1 and fc2
    # 2.779 each; attention 1.066 a block
    per_block = 2 * 589 * 768 * (2304 + 768 + 2 * 3072)
    assert sum(op.flops for op in by("gemm")) == pytest.approx(
        2 * 588 * 1536 * 768 + 12 * per_block)
    assert per_block / 1e9 == pytest.approx(2.0845 + 0.6948 + 2 * 2.7793,
                                            abs=1e-3)
    assert sum(op.flops for op in by("attn")) / 1e9 == pytest.approx(
        12 * 4 * 589 ** 2 * 768 / 1e9)


def test_attention_and_layernorm_bytes():
    ops = WV.ops(PRITHVI, HEAD, "bfloat16", 1)
    attn = [op for op in ops if WV.kind_of(op) == "attn"]
    # qkv (589 x 2,304) read and the heads' output (589 x 768) written, bf16
    assert all(op.bytes == 589 * 4 * 768 * 2 for op in attn)
    ln = [op for op in ops if WV.kind_of(op) == "ln"]
    assert len(ln) == 25
    # the first norm reads and writes its rows; the other 24 also read the
    # residual branch and write the sum; w and b float32
    assert ln[0].bytes == 589 * 768 * 2 * 2 + 2 * 768 * 4
    assert all(op.bytes == 589 * 768 * 2 * 4 + 2 * 768 * 4 for op in ln[1:])
    assert sum(op.bytes for op in ln) / 1e6 == pytest.approx(88.8, abs=0.1)


def test_least_time_of_a_tile():
    peak = W.peaks("NVIDIA H100 80GB HBM3", "bfloat16")
    w = WV.work(PRITHVI, HEAD, "bfloat16", 256, peak)
    assert w["flops"] == pytest.approx(256 * 114.2294e9, rel=1e-5)
    assert w["gemm_least_s"] * 1e3 == pytest.approx(26.26, abs=0.01)
    assert w["attn_least_s"] * 1e3 == pytest.approx(3.32, abs=0.01)
    assert w["ln_least_s"] * 1e3 == pytest.approx(6.78, abs=0.01)
    assert w["least_s"] > w["gemm_least_s"] + w["attn_least_s"] \
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
    for t0 in (10.2, 11.2):  # one call each: 2 attention, 3 LN, 4 K1 spans
        i = int(t0 * 100)
        recs += [_rec("satae.attn", i, t0 + 1e-3, 1.5),
                 _rec("satae.attn", i + 1, t0 + 2e-3, 0.5)]
        recs += [_rec("satae.ln", i + 2 + j, t0 + 3e-3, 0.25)
                 for j in range(3)]
        recs += [_rec("satae.k1", i + 5 + j, t0 + 4e-3, 2.0)
                 for j in range(4)]
    recs.append(_rec("satae.attn", 1, 5.0, 100.0))  # before the window
    monkeypatch.setattr(profiling, "spans",
                        lambda: profiling.Spans(recs, 0))
    run = _run({"attn_least_s": 1e-3, "ln_least_s": 0.5e-3,
                "gemm_least_s": 4e-3})
    assert _read("attn_ms_per_call.vit", run) == pytest.approx(2.0)
    assert _read("layernorm_ms_per_call.vit", run) == pytest.approx(0.75)
    # per call least time over the spans' time per call
    assert _read("attn_roofline_share.vit", run) == pytest.approx(50.0)
    assert _read("layernorm_roofline_share.vit", run) == pytest.approx(
        100 * 0.5 / 0.75)
    assert _read("k1_roofline_share.vit", run) == pytest.approx(50.0)


@pytest.mark.parametrize("name", NEW)
def test_readers_none_without_spans(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans",
                        lambda: profiling.Spans([], 0))
    run = _run({"attn_least_s": 1e-3, "ln_least_s": 1e-3,
                "gemm_least_s": 1e-3})
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
    assert traced >= set(NEW) | {"mfu.serve", "device_idle_share.serve",
                                 "kernels_roofline_share.serve"}
    assert {m["name"] for m in RUN.metrics_of(CELL, False)} == {
        "serve_images_per_s", "serve_call_p95_ms", "setup_s"}
