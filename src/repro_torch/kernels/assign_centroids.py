"""Wrapper of the hand-written CUDA ``assign_centroids`` kernel.

Counterpart of ``repro.kernels.centroid_assign.assign_centroids`` (the
Pallas TPU kernel).  The kernel (``csrc/assign_centroids.cu``) computes the
products of a resident 128-row (or 64-row) tile of X with streamed
128-centroid tiles on Hopper's tensor cores in 3xTF32 (each f32 operand
split into a TF32 hi and lo, three products per f32 one), and keeps a
running (min, argmin) per row.
``split_plan`` cuts the centroids into S chunks when the row tiles alone
would leave the card under two waves; pass 1 runs one CTA per (row tile,
chunk), and, when S > 1, a merge pass takes each row's S results in chunk
order (the earlier chunk first on equal values, so ties keep the lower
index exactly as one pass over all centroids).  This wrapper checks its
inputs, hoists ``||c||²`` and ``||x||²`` once per call, allocates the
outputs and the scratch, and launches on the current stream.  It takes CUDA
tensors only: CPU tensors go to ``kernels.ref`` through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# autotune: exempt(assign_centroids): WAVES, the one knob of its split plan,
# gives the same plan for every candidate (1-4) at the shapes its traffic
# gives it: n = 10^4 makes 79 row tiles, fewer than one wave of 132 SMs,
# and n = 10^6 (Lloyd, PQ training) makes 7,813 or 15,625, more than four.

ROWS = (64, 128)  # row tiles of pass 1 (the wgmma N; csrc/assign_centroids.cu)
COLS = 128       # centroids per tile (kCents); chunks are whole tiles
MAX_SPLITS = 64
WAVES = 2        # split when the row tiles fill fewer waves than this
SMALL_TILES = 2  # 64-row tiles when a chunk holds at most this many tiles
                 # (two CTAs an SM: PQ training's k = 256)


class AssignPlan(NamedTuple):
    """How ``assign_centroids`` splits its work: row tiles of ``rows`` rows
    (64 or 128), centroid chunks ``[s·chunk, (s+1)·chunk)`` for s <
    ``splits``, and ``ctas`` = row tiles × splits CTAs in pass 1."""
    rows: int
    chunk: int
    splits: int
    ctas: int


@functools.lru_cache(maxsize=256)
def split_plan(n: int, k: int, sms: int) -> AssignPlan:
    """The split of n rows × k centroids over ``sms`` SMs.

    Pure host arithmetic (no device read).  A 128-row CTA fills an SM (its
    resident tile and ring, ~220 registers a thread), so a plan costs
    rounds × (tiles per chunk + 1), the one tile standing for a CTA's fixed
    cost (the row tile's conversion, the ring's fill, the write-out).  Row
    tiles that fill ``WAVES`` waves alone keep one chunk; below that the
    cheapest even split is taken, the fewest chunks at equal cost.  When
    all centroids make at most ``SMALL_TILES`` tiles, the fixed cost rules,
    and 64-row tiles (two CTAs an SM) are taken instead.  An ``add`` batch
    (n = 10,000, k = 16,384) gets 5 chunks of 128-row tiles; n = 10^6 one
    chunk; PQ training (n ≈ 10^6, k = 256) one chunk of 64-row tiles.
    """
    tiles = max(1, -(-k // COLS))
    rows = ROWS[0] if tiles <= SMALL_TILES else ROWS[1]
    row_tiles = max(1, -(-n // rows))
    slots = max(1, sms * (2 if rows == 64 else 1))
    per = tiles
    if row_tiles < WAVES * slots:
        best = None
        for splits in range(1, min(tiles, MAX_SPLITS) + 1):
            p = -(-tiles // splits)
            cost = -(-(row_tiles * splits) // slots) * (p + 1)
            if best is None or cost < best[0]:
                best, per = (cost,), p
    splits = -(-tiles // per)
    return AssignPlan(rows, per * COLS, splits, row_tiles * splits)


def _fn():
    f = _build.library("assign_centroids").assign_centroids_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def assign_centroids(X: torch.Tensor, C: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(assign (n,) int32, d2 (n,) f32), computed by the CUDA kernel.

    X (n, d) f32 and C (k, d) f32, contiguous on one CUDA device, k >= 1.
    assign is the first minimum of ``||c||² − 2x·c`` (ties to the lower
    index); d2 = ``max(min + ||x||², 0)``.  One or two device launches
    (``split_plan``); the launch count adds one per call.
    """
    if X.dim() != 2 or C.dim() != 2:
        raise ValueError("X and C must be 2-D")
    n, d = X.shape
    k = C.shape[0]
    _build.check_tensor(X, "X", torch.float32, (n, d), X.device)
    _build.check_tensor(C, "C", torch.float32, (k, d), X.device)
    if k < 1:
        raise ValueError("need at least one centroid")
    csq, xsq = (C * C).sum(-1), (X * X).sum(-1)
    out_i = torch.empty((n,), dtype=torch.int32, device=X.device)
    out_d = torch.empty((n,), dtype=torch.float32, device=X.device)
    if n == 0:
        return out_i, out_d
    plan = split_plan(n, k, _build.sm_count(X.device.index))
    part_v = part_i = None
    if plan.splits > 1:
        part_v = torch.empty((n, plan.splits), dtype=torch.float32,
                             device=X.device)
        part_i = torch.empty((n, plan.splits), dtype=torch.int32,
                             device=X.device)
    _build.launch("assign_centroids", _fn(), X.device, X.data_ptr(),
                  C.data_ptr(), csq.data_ptr(), xsq.data_ptr(),
                  out_i.data_ptr(), out_d.data_ptr(),
                  None if part_v is None else part_v.data_ptr(),
                  None if part_i is None else part_i.data_ptr(), n, k, d,
                  plan.rows, plan.chunk, plan.splits)
    return out_i, out_d
