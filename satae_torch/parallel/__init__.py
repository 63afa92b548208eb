"""Multi-device runtime: the counterpart of satae/parallel, one process per
device over ``torch.distributed`` (the process model:
satae_torch.parallel.distributed)."""

from satae_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_grid_mesh,
    make_mesh,
    replicate,
    shard_batch,
)
