"""The device mesh over a process group: the counterpart of
satae/parallel/mesh.py, one rank per device (satae_torch.parallel.
distributed).

A :class:`Mesh` is 1-D (``make_mesh``: every rank on the data axis) or 2-D
(``make_grid_mesh``: config x data, the data axis innermost, so rank
``c * n_data + d`` trains config row ``c`` as its ``d``-th data shard, as
satae lays its devices, mesh.py:37-42). Its collectives run over the data
axis: the whole world on a 1-D mesh, the rank's config row on a 2-D one
(a process group per row, which every rank creates for every row in the
same order: a rank that skipped one would hang the others).
:func:`shard_batch` takes this rank's rows of axis 0 (satae's
``shard_batch`` puts them on their device), and :func:`replicate`
broadcasts tensors or a module's state from the axis's first rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from satae_torch.parallel.distributed import ensure_world

# all_gather_into_tensor's newer name, where PyTorch has it
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a 1-D (data) or 2-D (config x data) mesh."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    group: Optional[dist.ProcessGroup]  # the data axis; None: the world

    @property
    def data_size(self) -> int:
        return self.shape[self.axis_names[-1]]

    @property
    def data_rank(self) -> int:
        return self.rank % self.data_size

    @property
    def row(self) -> int:
        """The config row of a 2-D mesh (0 on a 1-D one)."""
        return self.rank // self.data_size

    @property
    def src(self) -> int:
        """The global rank of this data axis's first rank."""
        return self.row * self.data_size

    def shard(self, x):
        """This rank's rows of axis 0 of ``x``, whose length the data axis
        must divide."""
        n = len(x)
        if n % self.data_size:
            raise ValueError(f"{n} rows do not divide over {self.data_size} "
                             "devices")
        k = n // self.data_size
        return x[self.data_rank * k:(self.data_rank + 1) * k]

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The data axis's mean of each tensor, in one collective."""
        flat = _flatten_dense_tensors([t.detach() for t in tensors])
        flat = self.all_reduce_(flat) / self.data_size
        return list(_unflatten_dense_tensors(flat, tensors))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0, in rank order."""
        out = t.new_empty((t.shape[0] * self.data_size,) + t.shape[1:])
        _all_gather(out, t.contiguous(), group=self.group)
        return out

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite each tensor with the data axis's first rank's, in
        place."""
        for t in tensors:
            dist.broadcast(t, src=self.src, group=self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> Mesh:
    """A 1-D mesh over ``n_devices`` ranks (default: the whole world),
    which must be the process group's size (satae_torch.parallel.
    distributed.ensure_world: one rank makes its own group)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    ensure_world(n_devices, device)
    return Mesh((axis,), {axis: n_devices}, dist.get_rank(), None)


def make_grid_mesh(n_config: int, n_data: int = 1,
                   config_axis: str = "config", data_axis: str = "data",
                   device="cuda") -> Mesh:
    """A 2-D (config x data) mesh over ``n_config * n_data`` ranks: one
    grid config per row per round, each trained data-parallel over its
    row's ``n_data`` ranks (a process group per row)."""
    need = n_config * n_data
    try:
        ensure_world(need, device)
    except ValueError as e:
        raise ValueError(f"{n_config} config x {n_data} data: {e}") from None
    rank = dist.get_rank()
    group = None
    for c in range(n_config):
        g = dist.new_group(list(range(c * n_data, (c + 1) * n_data)))
        if rank // n_data == c:
            group = g
    return Mesh((config_axis, data_axis),
                {config_axis: n_config, data_axis: n_data}, rank, group)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of axis 0 of each array (host or device)."""
    out = tuple(mesh.shard(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, module_or_tensors):
    """The data axis's first rank's parameters and buffers (a module) or
    tensors, broadcast in place to every rank of the axis; returns its
    argument."""
    tensors = (list(module_or_tensors.state_dict().values())
               if isinstance(module_or_tensors, torch.nn.Module)
               else list(module_or_tensors))
    with torch.no_grad():
        mesh.broadcast_(tensors)
    return module_or_tensors
