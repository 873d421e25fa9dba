"""Collectives of the sharded topology over a ``torch.distributed`` group,
and their accounting.

Counterpart of the reference's ``_Comm`` hooks (``repro/core/engine.py``:
``_psum``, ``_all_gather``, ``_gather_stacked``) and of ``_TreeTopo``'s
combines.  ``Comm`` wraps one ProcessGroup and offers the forms the sharded
bodies need, in shapes both backends accept: ``all_reduce`` with SUM, MIN
or MAX, ``all_gather`` into a list, and ``all_to_all_single``.

The group's backend must match the tensors' device: NCCL with ``cuda``
tensors, gloo with ``cpu`` ones.  ``Comm.check`` raises on a mismatch; the
code never copies a tensor to the CPU to get round it.

Float sums whose value must not depend on the order of the ranks are added
in rank order through ``ordered_sum``, which the single-device R-way
emulation calls on its R blocks too, so a group and its emulation add the
same partials in the same order.  ``fsum`` gathers every rank's whole
tensor first (for small tensors: scalars, a tree level's sums);
``fsum_owned`` sums a cluster-sharded (R·k_loc, ...) tensor into the rank's
own k_loc rows: an all-to-all sends block t to rank t, which adds the R
blocks it receives in rank order — the same values as
``fsum(x)[rank·k_loc:(rank+1)·k_loc]`` while a rank holds k·d floats, not
R·k·d.  A sum whose every element is one owner's value plus zeros, and
integer sums, may use ``psum``: those are exact in any order.

Accounting.  Every collective is recorded into the innermost active
``collective_counter()`` (shaped like ``obs.syncs.sync_counter``): its
kind (the reference's HLO names ``all-gather``, ``all-reduce``,
``all-to-all``), dtype, shape, an optional label, the operand bytes and
the wire bytes of the reference's ring model
(``repro/launch/roofline.py``): all-gather result·(g−1)/g, all-reduce
2·result·(g−1)/g, all-to-all result·(g−1)/g.  ``RecordingComm`` is a
``Comm`` without a process group: it records the same calls and returns
tensors of the right shapes and dtypes without communicating (as if every
rank held this rank's values), for the clustering dry run, the in-process
contract audit and the card's one-rank body; no entry point of the system
uses it.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}
KINDS = ("all-gather", "all-reduce", "all-to-all")


def ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` added left to right, a new tensor."""
    tot = parts[0].clone()
    for p in parts[1:]:
        tot += p
    return tot


class Collective(NamedTuple):
    """One recorded collective call of one rank."""
    kind: str             # "all-gather" | "all-reduce" | "all-to-all"
    dtype: str            # e.g. "float32"
    shape: tuple          # the rank's operand shape
    label: str            # the call site's label, "" if none
    operand_bytes: int    # bytes the rank contributes
    wire_bytes: float     # bytes the rank moves (ring model)


def wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes one rank moves in a ring collective of ``g`` ranks whose
    result holds ``result_bytes`` (the reference's model)."""
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / g
    raise ValueError(f"unknown collective kind {kind!r}")


class CollectiveCounter:
    """The collectives recorded while it was the innermost active one."""

    def __init__(self) -> None:
        self.records: List[Collective] = []

    def counts(self) -> Dict[str, int]:
        """Calls by kind (kinds with none left out)."""
        out: Dict[str, int] = defaultdict(int)
        for r in self.records:
            out[r.kind] += 1
        return dict(out)

    def summary(self, label: Optional[str] = None) -> Dict[str, object]:
        """Per kind ``{"count", "bytes", "wire_bytes"}`` plus
        ``total_bytes`` and ``total_wire_bytes`` (the reference's
        ``collective_bytes`` layout), over the records with ``label``, or
        all of them."""
        out: Dict[str, object] = {k: {"count": 0, "bytes": 0.0,
                                      "wire_bytes": 0.0} for k in KINDS}
        for r in self.records:
            if label is not None and r.label != label:
                continue
            s = out[r.kind]
            s["count"] += 1
            s["bytes"] += r.operand_bytes
            s["wire_bytes"] += r.wire_bytes
        out["total_bytes"] = sum(out[k]["bytes"] for k in KINDS)
        out["total_wire_bytes"] = sum(out[k]["wire_bytes"] for k in KINDS)
        return out

    def by_label(self) -> Dict[str, Dict[str, float]]:
        """``{label: {"count", "bytes", "wire_bytes"}}`` over all kinds."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            s = out.setdefault(r.label, {"count": 0, "bytes": 0.0,
                                         "wire_bytes": 0.0})
            s["count"] += 1
            s["bytes"] += r.operand_bytes
            s["wire_bytes"] += r.wire_bytes
        return out


_active: List[CollectiveCounter] = []


@contextlib.contextmanager
def collective_counter() -> Iterator[CollectiveCounter]:
    """Record every collective any ``Comm`` makes inside the block (only
    the innermost active counter records)."""
    cc = CollectiveCounter()
    _active.append(cc)
    try:
        yield cc
    finally:
        _active.remove(cc)


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

    # the transport: every collective goes through one of these three
    def _all_reduce(self, out: torch.Tensor, op) -> None:
        dist.all_reduce(out, op=op, group=self.group)

    def _all_gather(self, outs: List[torch.Tensor], x: torch.Tensor) -> None:
        dist.all_gather(outs, x, group=self.group)

    def _all_to_all(self, out: torch.Tensor, x: torch.Tensor) -> None:
        dist.all_to_all_single(out, x, group=self.group)

    def _record(self, kind: str, x: torch.Tensor, result_bytes: int,
                label: str) -> None:
        if _active:
            _active[-1].records.append(Collective(
                kind, str(x.dtype).replace("torch.", ""), tuple(x.shape),
                label, x.numel() * x.element_size(),
                wire_bytes(kind, result_bytes, self.size)))

    def _reduce(self, x: torch.Tensor, op, label: str) -> torch.Tensor:
        self.check(x.device)
        out = x.contiguous().clone()
        self._record("all-reduce", out, out.numel() * out.element_size(),
                     label)
        self._all_reduce(out, op)
        return out

    def psum(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        """All-reduce SUM (integers, or owner-plus-zeros floats)."""
        return self._reduce(x, dist.ReduceOp.SUM, label)

    def pmin(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN, label)

    def pmax(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX, label)

    def gather_list(self, x: torch.Tensor, label: str = ""):
        """Every rank's ``x`` (equal shapes), in rank order."""
        self.check(x.device)
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        self._record("all-gather", x,
                     self.size * x.numel() * x.element_size(), label)
        self._all_gather(out, x)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   label: str = "") -> torch.Tensor:
        """Ranks' blocks concatenated along ``dim`` (the reference's tiled
        ``all_gather``)."""
        return torch.cat(self.gather_list(x, label), dim=dim)

    def gather_stacked(self, x: torch.Tensor,
                       label: str = "") -> torch.Tensor:
        """(R, ...) with a leading rank axis."""
        return torch.stack(self.gather_list(x, label))

    def fsum(self, x: torch.Tensor, label: str = "") -> torch.Tensor:
        """Float sum over ranks, added in rank order (every rank's whole
        ``x`` travels: for small tensors)."""
        return ordered_sum(self.gather_list(x, label))

    def fsum_owned(self, x: torch.Tensor, k_loc: int,
                   label: str = "") -> torch.Tensor:
        """Rows ``[rank·k_loc, (rank+1)·k_loc)`` of the rank-ordered float
        sum of every rank's ``x`` ((R·k_loc, ...)): one all-to-all of the
        rank blocks, then the R received blocks added in rank order.  Equal
        to ``fsum(x)[rank·k_loc:(rank+1)·k_loc]`` bit for bit."""
        self.check(x.device)
        R = self.size
        if x.shape[0] != R * k_loc:
            raise ValueError(f"fsum_owned: {x.shape[0]} rows, want "
                             f"{R} x {k_loc}")
        x = x.contiguous()
        out = torch.empty_like(x)
        self._record("all-to-all", x, out.numel() * out.element_size(),
                     label)
        self._all_to_all(out, x)
        return ordered_sum(out.view((R, k_loc) + x.shape[1:]).unbind(0))


class RecordingComm(Comm):
    """A ``Comm`` of ``size`` ranks seen from rank ``rank`` that moves
    nothing: each collective is recorded, allocates what the real one
    allocates, and returns what it would return if every rank held this
    rank's values (a reduce returns its operand: the other ranks add the
    identity).  Serves the dry run (``device="meta"``), the in-process
    audit and the card's one-rank body; no entry point uses it."""

    def __init__(self, rank: int, size: int, device) -> None:
        if not 0 <= rank < size:
            raise ValueError(f"need 0 <= rank < size, got {rank}, {size}")
        self.group = None
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = "recording"

    def check(self, device) -> None:
        if torch.device(device).type != self.device.type:
            raise ValueError(f"this RecordingComm takes {self.device.type} "
                             f"tensors, got {torch.device(device)}")

    def _all_reduce(self, out: torch.Tensor, op) -> None:
        pass

    def _all_gather(self, outs: List[torch.Tensor], x: torch.Tensor) -> None:
        for o in outs:
            o.copy_(x)

    def _all_to_all(self, out: torch.Tensor, x: torch.Tensor) -> None:
        R = self.size
        blk = x.view(R, -1)[self.rank]
        out.view(R, -1).copy_(blk.expand(R, -1))
