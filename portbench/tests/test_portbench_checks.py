"""The check that decides ``correct``, driven through the rest of a run on
the CPU (the harness's look for a card skipped, every cell at a small
size): sound runs pass, each fault that the cell's traffic kind declares
(``FAULTS`` of portbench/kinds/<kind>.py) planted in the program fails, and the control (the reference one precision below the
configuration's, in the program's place) fails. CPU only.

The limits are the cells' own (portbench/limits), set from readings on the
card at the cells' sizes; the sizes here keep each case to seconds."""

import pytest
import torch

from portbench import run as RUN
from portbench.reference import precision

CELLS = [w["name"] for w in RUN.load_manifest()["workloads"]]
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(cell):
    """Tiny widths, few rows: the same code paths as the card's run."""
    cell.config["model"].update(latent_dim=8, encoder_channels=[4, 8],
                                head_hidden=16, mlp_hidden=[16, 8])
    cell.config["data"]["image_size"] = 16
    t = cell.traffic
    if t["kind"] == "serve_tile":
        t.update(tile_images=700, calib_images=256)
    else:
        b = cell.config["data"]["batch_size"]
        t.update(train_images=4 * b + 20, unit_steps=2)
        cell.config["ae"]["alphas"] = cell.config["ae"]["alphas"][:2]
        cell.config["ae"]["learning_rates"] = \
            cell.config["ae"]["learning_rates"][:3]


def control_size(cell):
    """The control's rounding shows in the widest logit gap only over
    enough patches at the published widths: a 2,048-patch tile there;
    training cells as :func:`small`."""
    if cell.traffic["kind"] == "serve_tile":
        cell.traffic.update(tile_images=2048, calib_images=512)
    else:
        small(cell)


def _faults(cell):
    return RUN._module("kinds", RUN.load_cell(cell, 0).traffic["kind"]
                       ).FAULTS


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = RUN.run_cell(cell, SEED, 0.2, False, "cpu", edit=small)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in _faults(c)])
def test_fault_is_caught(cell, fault):
    with _faults(cell)[fault]():
        r = RUN.run_cell(cell, SEED + 1, 0.2, False, "cpu", edit=small)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r, session = RUN.run_cell(cell, SEED + 2, 0.2, False, "cpu",
                              edit=control_size, keep=True)
    assert r["correct"], r["checks"]
    _, q = precision.BELOW[session.cell.config["compute_dtype"]]
    nums, _ = session.compare(session.control_outputs(q),
                              session.cell.limits)
    assert any(v > session.cell.limits[k] for k, v in nums.items()), nums
