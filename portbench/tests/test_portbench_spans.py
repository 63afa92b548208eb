"""The readers of the program's spans (portbench/spans.py and the seven
metrics that use it), on a synthetic run and a faked span store: the value
from known spans, spans outside the window left out, and None without a
trace, without spans of the name, from a program without spans, and when
the store dropped records. CPU only."""

import pytest

from portbench import run as RUN
from portbench import spans as S
from portbench import trace as T
from satae_torch.utils import profiling

SERVE = ["prepare_ms_per_call.serve", "upload_gbps.serve",
         "k2_ms_per_call.serve", "k1_ms_per_call.serve"]
TRAIN = ["forward_ms_per_step.train", "backward_ms_per_step.train",
         "adam_ms_per_step.train"]
NEW = SERVE + TRAIN
S_NS = 1_000_000_000


def _rec(name, i, parent, t0_s, counts=None, device_ms=None):
    t0 = int(t0_s * S_NS)
    return profiling.SpanRecord(name, i, parent, t0, t0 + 1000,
                                counts or {}, device_ms)


def _run(units, totals, htod=(2, 0.004)):
    cell = RUN.Cell("c", {}, {}, 1, {}, 0)
    trace = T.Trace(window_s=1.0, busy_s=0.9, kernel_busy_s=0.5, kernels=10,
                    copies={"HtoD": htod} if htod else {})
    return RUN.Run(cell, 1.0, 1.0, units, {}, None, trace, totals)


def _serving_records(t0):
    """One call at ``t0`` s: serve, its upload 0.5 ms later (1 GB), two K2
    launches (1.5 + 2.5 ms) and one K1 (0.25 ms) of the card's time."""
    i = int(t0 * 100)
    return [_rec("satae.serve", i, None, t0),
            _rec("satae.serve.upload", i + 1, i, t0 + 0.0005,
                 {"bytes": 10 ** 9}),
            _rec("satae.k2", i + 2, i, t0 + 0.001, device_ms=1.5),
            _rec("satae.k2", i + 3, i, t0 + 0.002, device_ms=2.5),
            _rec("satae.k1", i + 4, i, t0 + 0.003, device_ms=0.25)]


def _training_records(t0):
    """One step at ``t0`` s: forward 30 ms, backward 70, Adam 4; a K1 span
    on the backward thread with no parent."""
    i = int(t0 * 100)
    return [_rec("satae.train.step", i, None, t0),
            _rec("satae.train.forward", i + 1, i, t0 + 1e-4, device_ms=30.0),
            _rec("satae.train.backward", i + 2, i, t0 + 2e-4,
                 device_ms=70.0),
            _rec("satae.k1", i + 3, None, t0 + 3e-4, device_ms=0.5),
            _rec("satae.train.adam", i + 4, i, t0 + 4e-4, device_ms=4.0)]


def _fake_store(monkeypatch, records, dropped=0):
    monkeypatch.setattr(profiling, "spans",
                        lambda: profiling.Spans(list(records), dropped))


def _read(name, run):
    return RUN._module("metrics", name).read(run)


# a window from 10 s to 12 s with two calls (or steps) in it; a call before
# it (a capture taken once more) and one after it
UNITS = [(10.0, 11.0, {}), (11.0, 12.0, {})]
OUTSIDE = [5.0, 12.5]


def test_serving_readers_from_known_spans(monkeypatch):
    recs = [r for t in (10.2, 11.2) + tuple(OUTSIDE)
            for r in _serving_records(t)]
    _fake_store(monkeypatch, recs)
    run = _run(UNITS, {"calls": 2, "images": 10})
    assert _read("prepare_ms_per_call.serve", run) == pytest.approx(0.5)
    # 2 GB in the window over 4 ms of HtoD copies
    assert _read("upload_gbps.serve", run) == pytest.approx(500.0)
    assert _read("k2_ms_per_call.serve", run) == pytest.approx(4.0)
    assert _read("k1_ms_per_call.serve", run) == pytest.approx(0.25)


def test_training_readers_from_known_spans(monkeypatch):
    recs = [r for t in (10.1, 10.6, 11.1, 11.6) + tuple(OUTSIDE)
            for r in _training_records(t)]
    _fake_store(monkeypatch, recs)
    run = _run(UNITS, {"steps": 4, "images": 40}, htod=None)
    assert _read("forward_ms_per_step.train", run) == pytest.approx(30.0)
    assert _read("backward_ms_per_step.train", run) == pytest.approx(70.0)
    assert _read("adam_ms_per_step.train", run) == pytest.approx(4.0)


def test_window_keeps_spans_that_start_inside_it(monkeypatch):
    edge = [_rec("satae.k2", 1, None, 10.0, device_ms=1.0),
            _rec("satae.k2", 2, None, 12.0, device_ms=1.0),
            _rec("satae.k2", 3, None, 9.999, device_ms=1.0),
            _rec("satae.k2", 4, None, 12.001, device_ms=1.0)]
    _fake_store(monkeypatch, edge)
    run = _run(UNITS, {"calls": 2})
    assert [r.id for r in S.window(run)] == [1, 2]
    assert _read("k2_ms_per_call.serve", run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", NEW)
def test_none_without_a_trace(monkeypatch, name):
    _fake_store(monkeypatch, _serving_records(10.2)
                + _training_records(10.5))
    run = _run(UNITS, {"calls": 1, "steps": 1})
    run.trace = None
    assert _read(name, run) is None


READS = {"prepare_ms_per_call.serve": "satae.serve",
         "upload_gbps.serve": "satae.serve.upload",
         "k2_ms_per_call.serve": "satae.k2",
         "k1_ms_per_call.serve": "satae.k1",
         "forward_ms_per_step.train": "satae.train.forward",
         "backward_ms_per_step.train": "satae.train.backward",
         "adam_ms_per_step.train": "satae.train.adam"}


@pytest.mark.parametrize("name", NEW)
def test_none_without_matching_spans(monkeypatch, name):
    # every other span in the window, and the metric's own outside it only
    inside = [r for r in _serving_records(10.2) + _training_records(10.5)
              if r.name != READS[name]]
    _fake_store(monkeypatch, inside + _serving_records(12.5)
                + _training_records(12.6))
    assert _read(name, _run(UNITS, {"calls": 1, "steps": 1})) is None


@pytest.mark.parametrize("name", NEW)
def test_none_when_the_store_dropped_records(monkeypatch, name):
    _fake_store(monkeypatch, _serving_records(10.2)
                + _training_records(10.5), dropped=1)
    assert _read(name, _run(UNITS, {"calls": 1, "steps": 1})) is None


@pytest.mark.parametrize("name", NEW)
def test_none_from_a_program_without_spans(monkeypatch, name):
    """The parent's program has no ``spans``: the readers return None and
    raise nothing."""
    monkeypatch.delattr(profiling, "spans")
    assert _read(name, _run(UNITS, {"calls": 1, "steps": 1})) is None


@pytest.mark.parametrize("name", ["k2_ms_per_call.serve",
                                  "forward_ms_per_step.train"])
def test_none_where_a_span_has_no_device_time(monkeypatch, name):
    recs = _serving_records(10.2) + _training_records(10.5)
    for r in recs:
        r.device_ms = None
    _fake_store(monkeypatch, recs)
    assert _read(name, _run(UNITS, {"calls": 1, "steps": 1})) is None


def test_prepare_needs_an_upload_for_every_call(monkeypatch):
    recs = [r for r in _serving_records(10.2) + _serving_records(11.2)
            if not (r.name == "satae.serve.upload" and r.t0_ns > 11 * S_NS)]
    _fake_store(monkeypatch, recs)
    run = _run(UNITS, {"calls": 2})
    assert _read("prepare_ms_per_call.serve", run) is None


def test_upload_rate_none_without_a_copy(monkeypatch):
    _fake_store(monkeypatch, _serving_records(10.2))
    assert _read("upload_gbps.serve",
                 _run(UNITS, {"calls": 1}, htod=None)) is None


def test_manifest_lists_the_new_metrics_in_their_cells():
    man = {m["name"]: m for m in RUN.load_manifest()["per_layer"]}
    for name in NEW:
        m = man[name]
        cell = "serve_tile.bf16" if name in SERVE else "grid_vmap.f32"
        assert m["workloads"] == [cell]
        assert m["source"] == ("program_counter" if name == "upload_gbps.serve"
                               else "program_span")
        assert name in {x["name"] for x in RUN.metrics_of(cell, True)}
        assert name not in {x["name"] for x in RUN.metrics_of(cell, False)}
