"""Per-epoch and per-round telemetry rows (counterpart of
``repro.obs.telemetry``).

A ``Telemetry`` is a fixed-shape pair of slot matrices — ``i32 (rows, 8)``
and ``f32 (rows, 5)`` — on one device.  Rows index epochs (the engine's
``run``) or rounds (a graph build); columns are the slot registry below,
with the reference's names and column indices: the column order is the
wire format that ``obs.emit`` records and ``launch/obs_report.py`` read.
Every producer writes a subset; unwritten slots stay 0.

  ==========================  ====  =====================================
  slot                        type  meaning (per row)
  ==========================  ====  =====================================
  ``moves``                   i32   engine: accepted moves this epoch
  ``proposed``                i32   engine: proposed moves BEFORE the
                                    leaver guard (its vetoes are
                                    ``proposed - moves``)
  ``empty_clusters``          i32   engine: clusters with cnt <= 0 at
                                    epoch end
  ``overflow``                i32   graph build: member-table overflow
                                    this round (``BuildDiagnostics``)
  ``guided_moves``            i32   graph build: guided-pass moves this
                                    round (``BuildDiagnostics``)
  ``graph_updates``           i32   graph build: neighbour-list entries
                                    changed by this round's refinement
  ``scanned_rows``            i32   IVF: packed rows scanned for the
                                    query batch, summed over shards
  ``scanned_rows_max_shard``  i32   IVF: the most-loaded shard's rows
  ``distortion``              f32   engine: end-of-epoch distortion
  ``hit_rate``                f32   engine: moves / max(proposed, 1)
  ``graph_mean_dist``         f32   graph build: mean finite neighbour
                                    distance after the round
  ``scan_frac``               f32   IVF: scanned_rows / (q * capacity)
  ``scanned_bytes``           f32   IVF: bytes streamed for the batch
  ==========================  ====  =====================================

The IVF slots are in the registry but no port module fills them yet (the
reference fills them only in its sharded IVF search).

Every helper treats ``None`` as "telemetry off" and passes it through, so a
pipeline gates on its config with ``tel = init(rows, dev) if cfg.telemetry
else None``.  ``record`` and ``record_rows`` write in place (the port's
state is mutable, as the engine's is) and return the same ``Telemetry``;
neither syncs the host, whether ``row`` is an int or a 0-d device tensor.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.obs import syncs

# slot name -> column index (order is the wire format: emit/report read it)
I32_SLOTS: Dict[str, int] = {
    "moves": 0,
    "proposed": 1,
    "empty_clusters": 2,
    "overflow": 3,
    "guided_moves": 4,
    "graph_updates": 5,
    "scanned_rows": 6,
    "scanned_rows_max_shard": 7,
}
F32_SLOTS: Dict[str, int] = {
    "distortion": 0,
    "hit_rate": 1,
    "graph_mean_dist": 2,
    "scan_frac": 3,
    "scanned_bytes": 4,
}
N_I32 = len(I32_SLOTS)
N_F32 = len(F32_SLOTS)


class Telemetry(NamedTuple):
    """Fixed-shape per-row slot matrices on one device."""

    i32: torch.Tensor  # (rows, N_I32) int32
    f32: torch.Tensor  # (rows, N_F32) float32

    @property
    def rows(self) -> int:
        return self.i32.shape[0]


def init(rows: int, device=None) -> Telemetry:
    """A zeroed accumulator with ``rows`` rows (0 rows is valid)."""
    return Telemetry(torch.zeros((rows, N_I32), dtype=torch.int32,
                                 device=device),
                     torch.zeros((rows, N_F32), dtype=torch.float32,
                                 device=device))


def column(tel: Telemetry, name: str) -> torch.Tensor:
    """One named column — (rows,) int32 or float32, a view."""
    if name in I32_SLOTS:
        return tel.i32[:, I32_SLOTS[name]]
    if name in F32_SLOTS:
        return tel.f32[:, F32_SLOTS[name]]
    raise KeyError(f"unknown telemetry slot {name!r}")


def record(tel: Optional[Telemetry], row, **slots) -> Optional[Telemetry]:
    """Write named slots of one row; ``row`` is an int or a 0-d integer
    tensor on ``tel``'s device, each value a number or a 0-d tensor.
    None -> None."""
    if tel is None:
        return None
    for name, v in slots.items():
        col = column(tel, name)
        if isinstance(row, torch.Tensor):
            val = (v.reshape(1) if isinstance(v, torch.Tensor) else
                   torch.full((1,), v, device=col.device))
            col.index_put_((row.reshape(1).long(),), val.to(col.dtype))
        elif isinstance(v, torch.Tensor):
            col[row].copy_(v)
        else:
            col[row].fill_(v)      # `col[row] = v` copies from the host
    return tel


def record_rows(tel: Optional[Telemetry], **slots) -> Optional[Telemetry]:
    """Write whole columns at once (each value a (rows,) tensor or
    sequence)."""
    if tel is None:
        return None
    for name, v in slots.items():
        col = column(tel, name)
        col.copy_(v if isinstance(v, torch.Tensor) else
                  torch.as_tensor(v, dtype=col.dtype))
    return tel


def pack(tel: Telemetry) -> torch.Tensor:
    """Both matrices as one flat float64 tensor on their device (exact for
    int32 and float32), so they travel to the host in one transfer beside
    other values; ``unpack`` inverts it."""
    return torch.cat([tel.i32.double().flatten(), tel.f32.double().flatten()])


def unpack(flat: torch.Tensor, rows: int) -> Telemetry:
    """The ``Telemetry`` that ``pack`` flattened, on ``flat``'s device."""
    ni = rows * N_I32
    return Telemetry(flat[:ni].view(rows, N_I32).to(torch.int32),
                     flat[ni:].view(rows, N_F32).to(torch.float32))


def to_dict(tel: Optional[Telemetry], rows: Optional[int] = None,
            slots: Optional[List[str]] = None) -> Dict[str, list]:
    """Host-side view: slot name -> python list (truncated to ``rows``).

    ``slots`` restricts the output (e.g. the engine writes only its five);
    default is every slot.  CPU tensors are read as they are; device tensors
    come to the host in one read through ``obs.syncs.read``, which the
    active ``sync_counter`` counts."""
    if tel is None:
        return {}
    i32, f32 = tel.i32, tel.f32
    if i32.device.type != "cpu" or f32.device.type != "cpu":
        i32, f32 = syncs.read((i32, f32))
    if rows is not None:
        i32, f32 = i32[:rows], f32[:rows]
    names = slots if slots is not None else (list(I32_SLOTS) + list(F32_SLOTS))
    out = {}
    for name in names:
        if name in I32_SLOTS:
            out[name] = [int(v) for v in i32[:, I32_SLOTS[name]].tolist()]
        elif name in F32_SLOTS:
            out[name] = [float(v) for v in f32[:, F32_SLOTS[name]].tolist()]
        else:
            raise KeyError(f"unknown telemetry slot {name!r}")
    return out
