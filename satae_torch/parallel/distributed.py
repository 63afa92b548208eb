"""Multi-process runtime initialization: the counterpart of
satae/parallel/distributed.py on ``torch.distributed``.

satae runs one controller over every device ``jax.devices()`` lists; the
port runs one process per device, as PyTorch does. A world of N ranks is
``runtime.n_devices = N``, each rank on ``cuda:LOCAL_RANK``
(:func:`local_device`). Every rank runs the same program from the same
seeds, satae's multi-process contract (distributed.py:26-30): host-side
results are identical on every rank, checkpoint and store writes are atomic
(a pid-unique tmp, then a rename) and write identical bytes, and figures and
reports are written by :func:`is_primary` only.

Initialization is opt-in (``RuntimeConfig.multihost``, ``satae_torch.cli
fit --multihost`` or ``SATAE_MULTIHOST=1``), idempotent, and a failure
propagates: a half-wired multi-process run must fail loudly, not train on
1/N of the data. It reads the launcher's environment (``init_method=
"env://"``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` sets them), with NCCL for a CUDA device and Gloo for the CPU.
A caller that has made its own default process group (another backend, a
file store) keeps it: every function here reads whatever group exists.

``runtime.n_devices = 1`` needs no launcher: :func:`ensure_world` makes a
single-rank group in the process from an in-process store, so the
data-parallel path runs its collectives on one device. ``n_devices = N > 1``
without a group of N ranks raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False


def multihost_requested(flag: Optional[bool] = None) -> bool:
    """True when initialization is requested by the flag or by the
    SATAE_MULTIHOST environment variable ("1"/"true"/"yes")."""
    if flag:
        return True
    return os.environ.get("SATAE_MULTIHOST", "").lower() in ("1", "true",
                                                             "yes")


def backend_for(device) -> str:
    """The collective backend of a device: NCCL for CUDA, Gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device) -> torch.device:
    """``device`` as this rank uses it: a CUDA device without an index is
    ``cuda:LOCAL_RANK`` once a process group exists (made current), else it
    is returned as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and \
            dist.is_initialized():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def maybe_initialize(flag: Optional[bool] = None,
                     device="cuda") -> bool:
    """Initialize the process group from the launcher's environment if (and
    only if) requested, with :func:`backend_for` ``device``'s backend.
    Idempotent; returns True when the process runs in a group after the
    call, False for the unchanged single-process default."""
    global _initialized
    if not multihost_requested(flag):
        return _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    dist.init_process_group(backend_for(device), init_method="env://")
    _initialized = True
    local_device(device)
    return True


def check_world(n_devices: int) -> None:
    """Raise ``ValueError`` unless a mesh of ``n_devices`` ranks can be
    built here: a process group of exactly that many, or none for one."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if not dist.is_initialized():
        if n > 1:
            raise ValueError(
                f"requested {n} devices, have 1: satae_torch runs one process "
                f"per device; launch `torchrun --nproc-per-node {n} -m "
                f"satae_torch.cli fit ... --multihost --n-devices {n}` (or "
                "initialize a process group of that many ranks first)")
    elif dist.get_world_size() != n:
        raise ValueError(f"requested {n} devices, have "
                         f"{dist.get_world_size()} (the process group's "
                         "ranks, one device each)")


def ensure_world(n_devices: int, device) -> None:
    """The world of ``n_devices`` ranks the mesh layer builds on
    (:func:`check_world`); a single rank without a group gets one of its
    own, from an in-process store, with ``device``'s backend."""
    check_world(n_devices)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)


def process_info() -> dict:
    """Process and device accounting for logs, satae's keys: one device per
    process."""
    up = dist.is_initialized()
    count = dist.get_world_size() if up else 1
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": count, "local_device_count": 1,
            "global_device_count": count}


def is_primary() -> bool:
    """True on the process that writes user-facing artifacts (figures,
    reports, the metrics log); checkpoint and store writes stay on every
    process (atomic, identical bytes)."""
    return not dist.is_initialized() or dist.get_rank() == 0
