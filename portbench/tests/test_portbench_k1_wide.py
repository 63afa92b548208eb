"""The reader of k1_wide_share.vit on a synthetic run and a faked span store:
the share of the window's ``satae.k1`` spans whose counter ``wide`` is 1,
spans outside the window left out, and None without a trace, without K1
spans, from spans that lack the counter (a program older than the wide
route), from a program without spans, and when the store dropped records.
CPU only."""

import pytest

from portbench import run as RUN
from portbench import trace as T
from satae_torch.utils import profiling

NAME = "k1_wide_share.vit"
CELL = "serve_hls.prithvi100m_bf16"
S_NS = 1_000_000_000
# a window from 10 s to 12 s with two calls in it
UNITS = [(10.0, 11.0, {}), (11.0, 12.0, {})]


def _rec(name, i, t0_s, counts=None):
    t0 = int(t0_s * S_NS)
    return profiling.SpanRecord(name, i, None, t0, t0 + 1000, counts or {},
                                0.5)


def _chunk(t0, wide=True):
    """One 64-chip chunk's K1 launches from ``t0`` s: 49 bf16 ones (on the
    wide route where ``wide``) and the head's 3 float32 ones, an attention
    span between them; ``wide`` None gives spans without the counter."""
    recs = []
    for i in range(52):
        counts = {} if wide is None else {"wide": int(bool(wide) and i < 49)}
        recs.append(_rec("satae.k1", int(t0 * 1000) + i, t0 + i * 1e-4,
                         counts))
    recs.append(_rec("satae.attn", int(t0 * 1000) + 60, t0 + 0.01,
                     {"tokens": 589}))
    return recs


def _run(traced=True):
    cell = RUN.Cell("c", {}, {}, 1, {}, 0)
    trace = T.Trace(window_s=1.0, busy_s=0.9, kernel_busy_s=0.5, kernels=10,
                    copies={}) if traced else None
    return RUN.Run(cell, 1.0, 1.0, UNITS, {}, None, trace, {"calls": 2})


def _store(monkeypatch, records, dropped=0):
    monkeypatch.setattr(profiling, "spans",
                        lambda: profiling.Spans(list(records), dropped))


def _read(run):
    return RUN._module("metrics", NAME).read(run)


@pytest.mark.parametrize("chunks, want", [
    ([True, True], 100.0 * 49 / 52),  # the ViT cell's route: 94.23 %
    ([False, False], 0.0),  # the parent's route, spans with the counter
    ([True, False], 100.0 * 49 / 104),
])
def test_share_of_wide_launches(monkeypatch, chunks, want):
    recs = [r for i, w in enumerate(chunks) for r in _chunk(10.2 + i, w)]
    # a chunk before the window (a capture taken once more) and one after,
    # on the parent's route, which must not count
    recs += _chunk(5.0, False) + _chunk(12.5, False)
    _store(monkeypatch, recs)
    assert _read(_run()) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no trace", "no k1 span", "no counter",
                                  "dropped", "no spans"])
def test_none_where_there_is_nothing_sound_to_read(monkeypatch, case):
    recs = _chunk(10.2) + _chunk(11.2)
    run = _run(traced=case != "no trace")
    if case == "no k1 span":
        recs = [r for r in recs if r.name != "satae.k1"] + _chunk(12.5)
    if case == "no counter":  # the parent's spans: no ``wide`` counter
        recs = _chunk(10.2, None) + _chunk(11.2, None)
    _store(monkeypatch, recs, dropped=int(case == "dropped"))
    if case == "no spans":
        monkeypatch.delattr(profiling, "spans")
    assert _read(run) is None


def test_manifest_lists_it_in_the_vit_cell_only():
    man = {m["name"]: m for m in RUN.load_manifest()["per_layer"]}
    m = man[NAME]
    assert m["workloads"] == [CELL] and m["unit"] == "%"
    assert m["source"] == "program_counter" and m["better"] == "higher"
    assert m["moves"] == "serve_images_per_s"
    assert NAME in {x["name"] for x in RUN.metrics_of(CELL, True)}
    assert NAME not in {x["name"] for x in RUN.metrics_of(CELL, False)}
    assert NAME not in {x["name"]
                        for x in RUN.metrics_of("serve_tile.bf16", True)}
