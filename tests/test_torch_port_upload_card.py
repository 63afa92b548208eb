"""The serving loop's sliced upload on a CUDA card (marker ``card``; each
test skips where there is no card): ``predict`` and ``encode`` of a whole
tile (29,241 patches, 64x64x3 uint8) in float32 (512-row chunks, 8 slices)
and in the bf16 throughput recipe (8,192-row chunks, 4 slices), from
page-locked host memory, and from pageable memory (one copy), equal bit for
bit the same calls over one copy of the whole tile; and changing the host
array right after a call returns changes nothing the call returned.

tests/conftest.py imports JAX, which the card's machine does not have, so
run this file there without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \
        tests/test_torch_port_upload_card.py
"""

import numpy as np
import pytest
import torch

from satae_torch import api
from satae_torch import config as C
from satae_torch.api import SatAEPipeline
from satae_torch.models.mlp import MLP
from satae_torch.models.supervised_ae import SupervisedAE

pytestmark = pytest.mark.card

TILE = 171 * 171
SIZE = 64


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy stream and page-locked "
                    "host memory exist only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tile(card):
    """The tile twice: page-locked, as a loader that pins its batches hands
    it on, and pageable, the same bytes."""
    g = torch.Generator().manual_seed(7)
    t = torch.randint(0, 256, (TILE, SIZE, SIZE, 3), dtype=torch.uint8,
                      generator=g)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return {"pinned": host.numpy(), "pageable": t.numpy().copy()}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pipe(card, request):
    cfg = C.PipelineConfig(
        runtime=C.RuntimeConfig(compute_dtype=request.param))
    if request.param == "bfloat16":
        cfg = C.throughput_config(cfg, 1024)
    torch.manual_seed(0)
    p = SatAEPipeline(cfg, device=card)
    p.ae = SupervisedAE(cfg.model, 3, SIZE).to(card).eval()
    p.mlp = MLP(cfg.model).to(card).eval()
    return p


@pytest.mark.parametrize("memory", ["pinned", "pageable"])
def test_sliced_upload_equals_one_copy(pipe, tile, monkeypatch, memory):
    """Page-locked: 8 slices in float32, 4 in bf16; pageable: one copy. Each
    answers bit for bit as one copy of the page-locked tile."""
    plan, plans = api.upload_slices, []

    def seen(n, chunk, overlap):
        plans.append(plan(n, chunk, overlap))
        return plans[-1]

    monkeypatch.setattr(api, "upload_slices", seen)
    got = pipe.predict(tile[memory]), pipe.encode(tile[memory])
    slices = (8 if pipe.config.compute_dtype == torch.float32 else 4) \
        if memory == "pinned" else 1
    assert [len(p) for p in plans] == [slices, slices]
    monkeypatch.setattr(api, "upload_slices",
                        lambda n, chunk, _: [(0, n + (-n) % chunk)])
    one = pipe.predict(tile["pinned"]), pipe.encode(tile["pinned"])
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])


def test_host_array_changed_after_the_call(pipe, tile):
    """The calls are done with the host's bytes when they return: changing
    them then leaves what they returned the answer for the old bytes."""
    imgs = tile["pinned"]
    keep = imgs.copy()
    try:
        preds, z = pipe.predict(imgs), pipe.encode(imgs)
        imgs[:] = 255 - imgs
        np.testing.assert_array_equal(preds, pipe.predict(keep))
        np.testing.assert_array_equal(z, pipe.encode(keep))
    finally:
        imgs[:] = keep
