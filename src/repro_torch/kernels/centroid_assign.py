"""Wrapper of the hand-written CUDA ``probe_centroids`` kernel.

Counterpart of ``repro.kernels.centroid_assign.probe_centroids`` (the Pallas
TPU kernel).  The kernel (``csrc/centroid_assign.cu``) computes FP32
register-blocked products of row tiles of X against centroid tiles without
materialising the (n, k) distance matrix, and splits and merges:
``split_plan`` picks a row tile (64 or 128 rows) and cuts the centroids into
S chunks, pass 1 runs one CTA per (row tile, chunk) and keeps that chunk's
sorted top-p per row, and, when S > 1, pass 2 merges the S partial lists of
each row in chunk order (the earlier chunk first among equal values, so
ties keep the lower centroid index, exactly as one pass over all
centroids).  The wrapper checks its inputs, hoists ``||c||²`` and
``||x||²`` once per call, allocates the outputs and the scratch, and
launches on the current stream.  It takes CUDA tensors only: CPU tensors go
to ``kernels.ref`` through ``kernels.ops``.  ``assign_centroids`` (the
nearest centroid alone) has its own kernel and wrapper,
``kernels.assign_centroids``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, autotune

MAX_P = 128     # the probe kernel's largest list (csrc/centroid_assign.cu)
ROWS = (64, 128)  # pass 1's row tiles (16·TM)
COLS = 128      # pass 1's centroid tile (PN)
UNIT = 64       # chunks are multiples of half a tile
MAX_SPLITS = 1024
_SM_SHARED = 233_472   # shared memory of one H100 SM (228 KB)
_CTA_RESERVED = 1_024  # of it the CUDA runtime reserves per resident CTA
_CTAS_PER_SM = 2       # __launch_bounds__(256, 2)
_ROW64_COST = 0.76     # a 64-row tile's time over a 128-row one's (4x8
                       # against 8x8 FMA blocks a thread; H100 estimate)


class ProbePlan(NamedTuple):
    """How ``probe_centroids`` splits its work: row tiles of ``rows`` rows,
    centroid chunks ``[s·chunk, (s+1)·chunk)`` for s < ``splits``, and
    ``ctas`` = row tiles × splits CTAs in pass 1."""
    rows: int
    chunk: int
    splits: int
    ctas: int


def pass1_smem(p: int, rows: int) -> int:
    """Bytes of shared memory one pass-1 CTA takes for lists of length p:
    a 3-stage ring of 16-deep slices of the row and centroid tiles (each
    padded by 4), half a tile of partials and the lists."""
    return 4 * (3 * 16 * (rows + 4 + COLS + 4) + rows * 68 + 2 * rows * p)


@functools.lru_cache(maxsize=256)
def split_plan(n: int, k: int, p: int, sms: int,
               ctas_per_sm: int = _CTAS_PER_SM) -> ProbePlan:
    """The probe's split of n rows × k centroids over ``sms`` SMs
    (``ctas_per_sm``: resident CTAs an SM in the cost model, the autotune
    table's knob).

    Pure host arithmetic (no device read, so ``search`` keeps no host
    sync).  A CTA's time grows with its chunk's tiles; the card runs
    ``slots`` CTAs at once (``sms`` × the CTAs that fit an SM at this p and
    row tile), so a plan costs rounds × (tiles per chunk + 1), the one tile
    standing for a CTA's fixed cost (pipeline fill, list write-out), a
    64-row tile at ``_ROW64_COST`` of a 128-row one.
    The plan takes the cheapest row tile and even split; at equal cost, one
    that gives every SM a CTA, then the fewest chunks (less merging).  A
    served batch (64 rows) gets 256 chunks of half a tile; rows that fill
    the card alone get one chunk or a few.
    """
    if not 1 <= p <= MAX_P:
        raise ValueError(f"need 1 <= p <= {MAX_P}, got {p}")
    units = max(1, -(-k // UNIT))
    best = None
    for rows in ROWS:
        row_tiles = -(-n // rows)
        per_sm = min(ctas_per_sm,
                     _SM_SHARED // (pass1_smem(p, rows) + _CTA_RESERVED))
        slots = max(1, sms * per_sm)
        scale = _ROW64_COST if rows == 64 else 1.0
        for per in range(units, 0, -1):     # half tiles per chunk
            splits = -(-units // per)
            if splits > MAX_SPLITS:
                break
            ctas = row_tiles * splits
            cost = -(-ctas // slots) * (-(-per // 2) + 1) * scale
            key = (cost, ctas < sms, splits, rows)
            if best is None or key < best[0]:
                best = (key, ProbePlan(rows, per * UNIT, splits, ctas))
    return best[1]


def _fn(name: str, nptrs: int, nints: int):
    f = getattr(_build.library("centroid_assign"), name)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * nptrs + [ctypes.c_int] * nints
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(X: torch.Tensor, C: torch.Tensor) -> Tuple[int, int, int]:
    if X.dim() != 2 or C.dim() != 2:
        raise ValueError("X and C must be 2-D")
    n, d = X.shape
    k = C.shape[0]
    _build.check_tensor(X, "X", torch.float32, (n, d), X.device)
    _build.check_tensor(C, "C", torch.float32, (k, d), X.device)
    return n, k, d


def _norms(X: torch.Tensor, C: torch.Tensor):
    return (C * C).sum(-1), (X * X).sum(-1)


def probe_centroids(X: torch.Tensor, C: torch.Tensor, p: int, *,
                    ctas_per_sm: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (n, p) int32, d2 (n, p) f32), computed by the CUDA kernels.

    The p nearest centroids of each row, ascending by ``||c||² − 2x·c``
    with ties to the lower index; d2 = ``max(part + ||x||², 0)``.
    1 <= p <= min(k, 128).  One or two device launches (``split_plan``, its
    ``ctas_per_sm`` from the autotune table unless given); the launch count
    adds one per call.
    """
    n, k, d = _check(X, C)
    if not 1 <= p <= min(k, MAX_P):
        raise ValueError(f"need 1 <= p <= min(k, {MAX_P}), got p={p}, k={k}")
    csq, xsq = _norms(X, C)
    out_i = torch.empty((n, p), dtype=torch.int32, device=X.device)
    out_d = torch.empty((n, p), dtype=torch.float32, device=X.device)
    if n == 0:
        return out_i, out_d
    cps = autotune.resolve("probe_centroids", autotune.BACKEND,
                           {"n": n, "k": k, "p": p}, ctas_per_sm)
    plan = split_plan(n, k, p, _build.sm_count(X.device.index), cps)
    part_v = part_i = None
    if plan.splits > 1:
        part_v = torch.empty((n, plan.splits, p), dtype=torch.float32,
                             device=X.device)
        part_i = torch.empty((n, plan.splits, p), dtype=torch.int32,
                             device=X.device)
    _build.launch("probe_centroids", _fn("probe_centroids_launch", 8, 7),
                  X.device, X.data_ptr(), C.data_ptr(), csq.data_ptr(),
                  xsq.data_ptr(), out_i.data_ptr(), out_d.data_ptr(),
                  None if part_v is None else part_v.data_ptr(),
                  None if part_i is None else part_i.data_ptr(), n, k, d, p,
                  plan.rows, plan.chunk, plan.splits)
    return out_i, out_d
