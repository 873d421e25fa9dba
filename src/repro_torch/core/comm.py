"""Collectives of the sharded topology over a ``torch.distributed`` group.

Counterpart of the reference's ``_Comm`` hooks (``repro/core/engine.py``:
``_psum``, ``_all_gather``, ``_gather_stacked``) and of ``_TreeTopo``'s
combines.  ``Comm`` wraps one ProcessGroup and offers the four forms the
sharded bodies need, in shapes both backends accept: ``all_reduce`` with
SUM, MIN or MAX, and ``all_gather`` into a list.

The group's backend must match the tensors' device: NCCL with ``cuda``
tensors, gloo with ``cpu`` ones.  ``Comm.check`` raises on a mismatch; the
code never copies a tensor to the CPU to get round it.

Float sums whose value must not depend on the order of the ranks are
gathered and added in rank order (``fsum``, through ``ordered_sum``, which
the single-device R-way emulation calls on its R blocks too), so a group
and its emulation add the same partials in the same order.  A sum whose
every element is one owner's value plus zeros, and integer sums, may use
``psum``: those are exact in any order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` added left to right, a new tensor."""
    tot = parts[0].clone()
    for p in parts[1:]:
        tot += p
    return tot


class Comm:
    """One process group's collectives (every rank calls each in turn)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised: call "
                               "repro_torch.launch.mesh.init_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group)).lower()
        if self.backend not in _BACKEND_DEVICE:
            raise ValueError(f"backend {self.backend!r}: the sharded "
                             "topology runs on 'nccl' (cuda) or 'gloo' (cpu)")

    def check(self, device) -> None:
        """Raise unless ``device`` is the one this group's backend serves."""
        want = _BACKEND_DEVICE[self.backend]
        if torch.device(device).type != want:
            raise ValueError(
                f"a {self.backend} group takes {want} tensors, got "
                f"{torch.device(device)}: use "
                f"{'nccl' if want == 'cpu' else 'gloo'} for those, or move "
                f"the tensors to {want}")

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self.check(x.device)
        out = x.contiguous().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM (integers, or owner-plus-zeros floats)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def gather_list(self, x: torch.Tensor):
        """Every rank's ``x`` (equal shapes), in rank order."""
        self.check(x.device)
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Ranks' blocks concatenated along ``dim`` (the reference's tiled
        ``all_gather``)."""
        return torch.cat(self.gather_list(x), dim=dim)

    def gather_stacked(self, x: torch.Tensor) -> torch.Tensor:
        """(R, ...) with a leading rank axis."""
        return torch.stack(self.gather_list(x))

    def fsum(self, x: torch.Tensor) -> torch.Tensor:
        """Float sum over ranks, added in rank order."""
        return ordered_sum(self.gather_list(x))
