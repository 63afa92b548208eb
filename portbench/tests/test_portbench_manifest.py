"""BENCHMARK.json against the benchmark's contract, every cell resolved to the
files the harness finds by name, and the import guard. CPU only."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as RUN

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits the time a check has
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in MAN["configs"]] + CELLS \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and _one_line(c["source"])
        assert _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _one_line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"])
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = RUN.load_cell(cell, 0)
    assert (ROOT / "portbench/kinds" / f"{c.traffic['kind']}.py").is_file()
    for key in ("trace_units",):
        assert c.traffic[key] >= 2
    cfg = {x["name"]: x for x in MAN["configs"]}[
        {w["name"]: w for w in MAN["workloads"]}[cell]["config"]]
    assert c.config["name"] == cfg["name"]
    assert c.config["source"] == cfg["source"]
    assert c.config["reduced"] == cfg["reduced"]
    assert c.limits and all(v > 0 for v in c.limits.values())
    e2e = RUN.metrics_of(cell, False)
    per = RUN.metrics_of(cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per
    for m in e2e + per:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
    moved = {m["name"] for m in e2e}
    assert all(m["moves"] in moved for m in per)


def test_layers_are_named_as_perf_md_lists_them():
    listed = (ROOT / "PERF.md").read_text()
    for m in MAN["per_layer"]:
        assert f"| {m['layer']} |" in listed, m["layer"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = RUN.forbidden_modules()
    monkeypatch.setitem(sys.modules, "satae_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary.x", sys)
    assert RUN.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in RUN.forbidden_modules()


def test_a_run_loads_no_jax():
    """Everything a run imports (the harness, every kind, reader and the
    program's modules they reach), in a fresh process: no top-level jax,
    jaxlib, flax or satae."""
    code = r"""
import sys
sys.path.insert(0, %r)
from portbench import run, trace, work, inputs
from portbench.reference import model, precision
import satae_torch.api, satae_torch.train.hbm, satae_torch.models.stacked
import satae_torch.nn.layers, satae_torch.train.optim, satae_torch.config
for kind in ("kinds", "metrics"):
    for f in sorted((run.BENCH / kind).glob("*.py")):
        run._module(kind, f.stem)
print(run.forbidden_modules())
""" % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs none")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr
