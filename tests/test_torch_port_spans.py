"""The port's spans (``satae_torch.utils.profiling.span``), on the CPU:

  * off (no profiler session): the one shared do-nothing object, no
    ``record_function`` entered, nothing stored;
  * on, under a CPU ``torch.profiler`` session: records with names, parents
    on a per-thread stack, ordered host times and counts, and the same names
    on the profiler's own time line;
  * a device span's two CUDA events, read once by ``spans()`` (a stand-in
    event class: no card here);
  * the store's bound and its count of dropped spans, also with threads
    opening spans at once;
  * ``launch_span``: a kernel launch counted on a clean exit only, on or
    off, and in no wrapper's count where none is given (``launch_counts()``
    on the card: the kernel and fit phases of chip_smoke.py);
  * a CPU ``predict`` / ``predict_proba`` / ``encode`` (one ``satae.serve``
    around one ``satae.serve.upload`` of the uint8 input's bytes, none of
    them overlapped; over the card's slice plan the later slices' bytes,
    and ``upload_overlapped_share.serve``'s reading of them) and a
    stacked AE train step (``satae.train.step`` around its three phases);
  * ``trace``'s Chrome trace carrying the spans.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_threads import two_threads  # noqa: F401 (autouse)
from portbench import run as RUN
from satae_torch import api
from satae_torch import config as C
from satae_torch.api import SatAEPipeline
from satae_torch.kernels import matmul
from satae_torch.models.mlp import MLP
from satae_torch.models.stacked import StackedSupervisedAE
from satae_torch.models.supervised_ae import SupervisedAE
from satae_torch.train import optim
from satae_torch.train.steps import stacked_ae_train_step
from satae_torch.utils import profiling

MC = C.ModelConfig(latent_dim=8, encoder_channels=(4, 8), head_hidden=16,
                   mlp_hidden=(16, 8))
IMG = 16


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


@pytest.mark.parametrize("kwargs", [{}, {"device": True},
                                    {"device": False, "bytes": 12}])
def test_off_span_is_shared_and_records_nothing(monkeypatch, kwargs):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    s = profiling.span("satae.test", **kwargs)
    assert s is profiling._OFF
    with s as got:
        assert got is None
    with profiling.span("satae.outer"):
        with profiling.span("satae.inner", **kwargs):
            pass
    got = profiling.spans()
    assert got.records == [] and got.dropped == 0


def test_off_span_passes_exceptions_through():
    with pytest.raises(KeyError):
        with profiling.span("satae.test"):
            raise KeyError("x")


def test_on_spans_nest_in_order_and_reach_the_profiler():
    with _cpu_profile() as prof:
        with profiling.span("satae.a", calls=1) as a:
            with profiling.span("satae.b", bytes=40):
                pass
            with profiling.span("satae.c"):
                pass
        with profiling.span("satae.d"):
            pass
    recs = profiling.spans().records
    assert [r.name for r in recs] == ["satae.a", "satae.b", "satae.c",
                                      "satae.d"]
    ra, rb, rc, rd = recs
    assert ra is a
    assert ra.parent is None and rd.parent is None
    assert rb.parent == ra.id and rc.parent == ra.id
    assert len({r.id for r in recs}) == 4
    assert ra.counts == {"calls": 1} and rb.counts == {"bytes": 40}
    assert rc.counts == {}
    for r in recs:
        assert r.t0_ns <= r.t1_ns and r.device_ms is None
    assert ra.t0_ns <= rb.t0_ns <= rb.t1_ns <= rc.t0_ns <= rc.t1_ns \
        <= ra.t1_ns <= rd.t0_ns
    names = {e.name for e in prof.events()}
    assert {"satae.a", "satae.b", "satae.c", "satae.d"} <= names


def test_on_span_closes_on_an_exception():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with profiling.span("satae.outer"):
                with profiling.span("satae.inner"):
                    raise ValueError("x")
        with profiling.span("satae.after"):
            pass
    outer, inner, after = profiling.spans().records
    assert inner.parent == outer.id and after.parent is None
    assert outer.t1_ns is not None and inner.t1_ns is not None


class _Event:
    """A stand-in for torch.cuda.Event on a machine without a card: a
    recorded host clock; elapsed_time in ms, as CUDA's."""
    synced = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = len(_Event.log)
        _Event.log.append(self)

    def synchronize(self):
        _Event.synced += 1

    def elapsed_time(self, end):
        assert _Event.synced, "read before the card reached it"
        return 0.5 * (end.t - self.t)


@pytest.fixture
def fake_events(monkeypatch):
    _Event.log, _Event.synced = [], 0
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    return _Event


def test_device_span_reads_its_events_when_read(fake_events):
    with _cpu_profile():
        with profiling.span("satae.host"):
            with profiling.span("satae.dev", device=True):
                with profiling.span("satae.dev2", device=True):
                    pass
        assert fake_events.synced == 0  # nothing waits while recording
    host, dev, dev2 = profiling.spans().records
    assert fake_events.synced >= 1
    assert host.device_ms is None and host.events is None
    assert len(fake_events.log) == 4
    assert dev.device_ms == 1.5 and dev2.device_ms == 0.5
    assert dev.events is None and dev2.events is None
    again = profiling.spans().records
    assert [r.device_ms for r in again] == [None, 1.5, 0.5]


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling._store, "capacity", 3)
    with _cpu_profile():
        with profiling.span("satae.outer"):
            for _ in range(4):
                with profiling.span("satae.inner"):
                    pass
    got = profiling.spans()
    assert [r.name for r in got.records] == ["satae.outer"] + \
        ["satae.inner"] * 2
    assert got.dropped == 2
    assert all(r.parent == got.records[0].id for r in got.records[1:])
    profiling.reset_spans()
    got = profiling.spans()
    assert got.records == [] and got.dropped == 0


def test_spans_from_many_threads(monkeypatch):
    """Threads opening nested spans at once, more threads than cores and a
    short switch interval: every span is kept or counted as dropped, ids
    are unique, and each child's parent is its own thread's outer span.
    A profiler session is on for the thread that opened it (and the
    autograd threads it hands work to), so here the spans are switched on
    for every thread by hand, record_function left out."""
    threads, per = 12, 60
    monkeypatch.setattr(profiling._store, "capacity", threads * per)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: profiling._OFF)
    errors = []

    def work():
        try:
            for _ in range(per):
                with profiling.span("satae.outer") as outer:
                    with profiling.span("satae.inner") as inner:
                        if inner is not None and inner.parent != outer.id:
                            errors.append((outer.id, inner.parent))
        except Exception as e:  # reported below, with the thread's failure
            errors.append(e)

    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    got = profiling.spans()
    assert len(got.records) + got.dropped == 2 * threads * per
    assert len(got.records) == threads * per and got.dropped == threads * per
    assert len({r.id for r in got.records}) == len(got.records)


@pytest.mark.parametrize("on", [False, True])
def test_launch_span_counts_clean_launches(on, fake_events):
    def wrapper():
        pass
    wrapper.launches = {"": 0, "_bf16": 0}

    def launches():
        with matmul.launch_span("satae.k1", wrapper, torch.float32):
            pass
        with matmul.launch_span("satae.k1", wrapper, torch.bfloat16):
            pass
        with pytest.raises(RuntimeError):
            with matmul.launch_span("satae.k1", wrapper, torch.float32):
                raise RuntimeError("refused launch")
        with matmul.launch_span("satae.k1", None, torch.float32):
            pass  # a launch no wrapper counts

    if on:
        with _cpu_profile():
            launches()
    else:
        launches()
    assert wrapper.launches == {"": 1, "_bf16": 1}
    recs = profiling.spans().records
    if on:
        assert [r.name for r in recs] == ["satae.k1"] * 4
        assert [r.device_ms for r in recs] == [0.5] * 4
    else:
        assert recs == [] and fake_events.log == []


def _u8(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    p = SatAEPipeline(C.PipelineConfig(data=C.DataConfig(image_size=IMG),
                                       model=MC), device="cpu")
    p.ae, p.mlp = SupervisedAE(MC, 3, IMG).eval(), MLP(MC).eval()
    return p


@pytest.mark.parametrize("method", ["predict", "predict_proba", "encode"])
def test_cpu_serving_call_spans(pipe, method):
    imgs = _u8(70)
    call = getattr(pipe, method)
    expect = call(imgs)
    with _cpu_profile() as prof:
        got = call(imgs)
    np.testing.assert_array_equal(got, expect)
    recs = profiling.spans().records
    by = _by_name(recs)
    assert set(by) == {"satae.serve", "satae.serve.upload"}
    (serve,), (upload,) = by["satae.serve"], by["satae.serve.upload"]
    assert serve.parent is None and upload.parent == serve.id
    assert upload.counts == {"bytes": imgs.nbytes, "overlapped_bytes": 0}
    assert serve.t0_ns <= upload.t0_ns <= upload.t1_ns <= serve.t1_ns
    names = {e.name for e in prof.events()}
    assert {"satae.serve", "satae.serve.upload"} <= names


def test_cpu_serving_float_input_uploads_the_uint8_bytes(pipe):
    imgs = _u8(5, seed=1)
    with _cpu_profile():
        pipe.predict(imgs.astype(np.float32) / 255.0)
    (upload,) = _by_name(profiling.spans().records)["satae.serve.upload"]
    assert upload.counts == {"bytes": imgs.nbytes, "overlapped_bytes": 0}


def test_cpu_serving_sliced_upload_counts_the_later_slices(pipe,
                                                          monkeypatch):
    """Over the plan of page-locked rows on a card (600 rows: chunks of 512,
    two slices),
    the upload span counts the whole input and, as overlapped, the second
    slice's 88 rows; ``upload_overlapped_share.serve`` reads their share."""
    imgs = _u8(600, seed=2)
    plan = api.upload_slices
    monkeypatch.setattr(api, "upload_slices",
                        lambda n, chunk, _: plan(n, chunk, True))
    with _cpu_profile():
        pipe.predict(imgs)
    recs = profiling.spans().records
    (upload,) = _by_name(recs)["satae.serve.upload"]
    assert upload.counts == {"bytes": imgs.nbytes,
                             "overlapped_bytes": 88 * imgs[0].nbytes}
    t0 = min(r.t0_ns for r in recs) * 1e-9
    run = RUN.Run(RUN.Cell("c", {}, {}, 1, {}, 0), 1.0, 1.0,
                  [(t0, t0 + 60.0, {})], {}, None, object(), {"calls": 1})
    assert _share(run) == pytest.approx(100.0 * 88 / 600)


def _share(run):
    return RUN._module("metrics", "upload_overlapped_share.serve").read(run)


def test_overlapped_share_reads_nothing_without_the_counter(monkeypatch):
    """None from a program whose upload span has no ``overlapped_bytes``
    (one older than it), from a window without upload spans, and without
    a trace; 0 % from single-copy calls."""
    def rec(i, **counts):
        return profiling.SpanRecord("satae.serve.upload", i, None,
                                    10 ** 10 + i, 10 ** 10 + i + 1, counts)

    run = RUN.Run(RUN.Cell("c", {}, {}, 1, {}, 0), 1.0, 1.0,
                  [(9.0, 11.0, {})], {}, None, object(), {"calls": 2})
    stores = {"older": [rec(0, bytes=100), rec(1, bytes=100)],
              "mixed": [rec(0, bytes=100),
                        rec(1, bytes=100, overlapped_bytes=60)],
              "none": [],
              "single": [rec(0, bytes=100, overlapped_bytes=0)] * 2,
              "sliced": [rec(0, bytes=100, overlapped_bytes=60),
                         rec(1, bytes=300, overlapped_bytes=240)]}
    got = {}
    for name, recs in stores.items():
        monkeypatch.setattr(profiling, "spans",
                            lambda recs=recs: profiling.Spans(recs, 0))
        got[name] = _share(run)
    assert got == {"older": None, "mixed": None, "none": None,
                   "single": 0.0, "sliced": pytest.approx(75.0)}
    run.trace = None
    assert _share(run) is None


def test_stacked_ae_step_spans_its_phases():
    c, b = 2, 4
    torch.manual_seed(0)
    model = StackedSupervisedAE(MC, c, 3, IMG)
    opt = optim.adam_init(list(model.parameters()))
    data = C.DataConfig(image_size=IMG, batch_size=b)
    gen = torch.Generator().manual_seed(1)
    with _cpu_profile() as prof:
        stacked_ae_train_step(model, opt, torch.from_numpy(_u8(b)),
                              torch.arange(b) % 10,
                              torch.tensor([20.0, 35.0]),
                              torch.tensor([1e-3, 5e-3]), data,
                              generator=gen)
    recs = profiling.spans().records
    assert [r.name for r in recs] == ["satae.train.step",
                                      "satae.train.forward",
                                      "satae.train.backward",
                                      "satae.train.adam"]
    step, fwd, bwd, adam = recs
    assert step.parent is None
    assert {fwd.parent, bwd.parent, adam.parent} == {step.id}
    assert fwd.t1_ns <= bwd.t0_ns and bwd.t1_ns <= adam.t0_ns
    assert all(r.device_ms is None for r in recs)  # on the CPU: host only
    names = {e.name for e in prof.events()}
    assert {r.name for r in recs} <= names


def test_trace_writes_the_spans(tmp_path):
    with profiling.trace(tmp_path):
        with profiling.span("satae.serve"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "satae.serve" in names and "aten::matmul" in names
    assert [r.name for r in profiling.spans().records] == ["satae.serve"]
