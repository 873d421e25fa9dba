"""Process-group setup for the sharded topology (``torch.distributed``).

Counterpart of ``repro.launch.mesh``: where the reference builds a device
mesh, the port joins a process group.  ``init_group`` reads ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or takes an explicit rank, world size and store — a
``FileStore`` path serves processes on one host without any network:

    group = init_group("cpu", rank=r, world_size=4, store_path=tmp / "st")

The backend follows the device: NCCL for ``cuda`` (each rank on the card
``LOCAL_RANK``, or ``rank`` modulo the cards of the host), gloo for
``cpu``.  NCCL takes one rank a card.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device


def init_group(device: DeviceLike = None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               store_path: Optional[str] = None) -> torch.device:
    """Join the default process group; returns this rank's device.

    ``device`` None means ``cuda`` (raises without a card).  Without
    ``rank``, the rank and world size come from the environment
    (``torchrun``); with it, ``world_size`` and ``store_path`` (a file every
    rank can reach) are needed.  A group that is already initialised is
    kept.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", -1))
        if local < 0:
            local = (rank or 0) % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if rank is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if world_size is None or store_path is None:
            raise ValueError("an explicit rank needs world_size and "
                             "store_path")
        dist.init_process_group(
            backend, store=dist.FileStore(str(store_path), world_size),
            rank=rank, world_size=world_size)
    return dev


def close_group() -> None:
    """Leave the default process group (a no-op when none is joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
