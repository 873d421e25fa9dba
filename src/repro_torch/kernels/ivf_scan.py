"""Wrapper of the hand-written CUDA ``ivf_scan`` kernel.

Counterpart of ``repro.kernels.ivf_scan.ivf_scan`` (the Pallas TPU kernel).
The kernels (``csrc/ivf_scan.cu``) split and merge: ``split_plan`` cuts each
query's live slots (``live_slots``: an in-range tile with a live row) into
S contiguous chunks in slot order (``slot_chunks``), one CTA each, whose
eight warps keep private running top-k lists that the CTA merges by
(value, candidate position); when S > 1 a second pass merges each query's
S partial lists in chunk order (strict insert, so the reference's
slot-then-row order holds).  This wrapper checks its inputs, allocates the
outputs and the scratch, and launches on the current stream of the tensors'
device.  It takes CUDA tensors only: CPU tensors go to
``kernels.ref.ivf_scan`` through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# autotune: exempt(ivf_scan): CTAS_PER_SM, the one knob of its split plan,
# gives one plan for every candidate (2-32) at 1,000 queries or more,
# and at the served batch (64 queries, nprobe 16) no candidate beat
# today's 8 by more than the spread between rounds in two sweeps on the
# H100: the table would hold nothing for it.

MAX_TOPK = 1024     # the kernel's largest list (csrc/common.cuh)
CTAS_PER_SM = 8     # the split's target: pass 1 holds 8 CTAs an SM
MAX_MERGE = 32_768  # candidates one merging warp takes per query, at most
INT_MAX = 2**31 - 1  # candidate positions and row indices are C ints


class ScanPlan(NamedTuple):
    """How ``ivf_scan`` splits its work: each query's live slots in
    ``splits`` chunks (``slot_chunks``), ``ctas`` CTAs in pass 1."""
    splits: int
    ctas: int


def split_plan(nq: int, T: int, topk: int, sms: int) -> ScanPlan:
    """The per-query scan's split of nq queries of T map slots over
    ``sms`` SMs.

    Pure host arithmetic (no device read, so ``search`` keeps no host
    sync).  One chunk per query once the queries alone fill the card
    (nq >= sms); else as many chunks as keep pass 1 within one wave of
    ``CTAS_PER_SM`` CTAs per SM (rounded down: a CTA past the wave would
    run alone after it), at most T (a query has at most T live slots) and
    at most ``MAX_MERGE`` merged candidates per query.  ``ivf_scan_adc``
    takes the same plan.
    """
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"need 1 <= topk <= {MAX_TOPK}, got {topk}")
    splits = 1
    if 0 < nq < sms:
        splits = max(1, min(CTAS_PER_SM * sms // nq, T, MAX_MERGE // topk))
    return ScanPlan(splits, nq * splits)


def live_slots(tile_map: torch.Tensor, pids: torch.Tensor,
               block_rows: int) -> torch.Tensor:
    """(q, T) bool: the map slots the kernel scans — a tile in
    [0, n_pad / block_rows) that holds a live row (pids >= 0).  The
    other slots give no candidate."""
    n_tiles = pids.shape[0] // block_rows
    tm = tile_map.long()
    inr = (tm >= 0) & (tm < n_tiles)
    tile_live = (pids.view(n_tiles, block_rows) >= 0).any(1)
    return inr & tile_live[tm.clamp(0, max(n_tiles - 1, 0))]


def slot_chunks(live: torch.Tensor, splits: int) -> torch.Tensor:
    """(q, splits + 1) int64 bounds in live-slot counts: chunk s of query q
    is its live slots [b[q, s], b[q, s+1]) in slot order.

    The kernel's own cut, on any device: ceil(live / splits) live slots a
    chunk, the last ones possibly short or empty.
    """
    n = live.sum(1)
    per = (n + splits - 1) // splits
    s = torch.arange(splits + 1, device=live.device)
    return torch.minimum(s[None, :] * per[:, None], n[:, None])


def _fn():
    f = _build.library("ivf_scan").ivf_scan_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def ivf_scan(Q: torch.Tensor, vecs: torch.Tensor, pids: torch.Tensor,
             tile_map: torch.Tensor, *, block_rows: int, topk: int = 10,
             raw: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (q, topk) int32, d2 (q, topk) f32), computed by the CUDA kernel.

    Q (q, d) f32; vecs (n_pad, d) f32 with n_pad a multiple of block_rows;
    pids (n_pad,) int32, -1 at holes; tile_map (q, T) int32 tile indices —
    all contiguous on one CUDA device.  ids are -1 past the candidate count;
    d2 is ``max(part + ||q||², 0)``, or the partials ``||v||² − 2q·v`` with
    ``raw=True`` (+inf at -1 slots).  1 <= topk <= 1024.  One or two
    device launches (``split_plan``); the launch count adds one per call.
    """
    if Q.dim() != 2 or vecs.dim() != 2 or tile_map.dim() != 2:
        raise ValueError("Q, vecs and tile_map must be 2-D")
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"need 1 <= topk <= {MAX_TOPK}, got {topk}")
    nq, d = Q.shape
    n_pad = vecs.shape[0]
    if block_rows < 1 or n_pad % block_rows:
        raise ValueError(f"n_pad {n_pad} is not a multiple of block_rows "
                         f"{block_rows}")
    T = tile_map.shape[1]
    if max(T * block_rows, n_pad) > INT_MAX:
        raise ValueError(f"T * block_rows = {T * block_rows} candidates per "
                         f"query or n_pad = {n_pad} rows exceed the "
                         f"kernel's {INT_MAX} positions")
    dev = Q.device
    _build.check_tensor(Q, "Q", torch.float32, (nq, d), dev)
    _build.check_tensor(vecs, "vecs", torch.float32, (n_pad, d), dev)
    _build.check_tensor(pids, "pids", torch.int32, (n_pad,), dev)
    _build.check_tensor(tile_map, "tile_map", torch.int32, (nq, T), dev)
    out_i = torch.empty((nq, topk), dtype=torch.int32, device=dev)
    out_d = torch.empty((nq, topk), dtype=torch.float32, device=dev)
    if nq == 0:
        return out_i, out_d
    plan = split_plan(nq, T, topk, _build.sm_count(dev.index))
    scratch = []
    if plan.splits > 1:
        scratch = [
            torch.empty((nq, plan.splits, topk), dtype=torch.float32,
                        device=dev),
            torch.empty((nq, plan.splits, topk), dtype=torch.int32,
                        device=dev),
            torch.empty((nq,), dtype=torch.float32, device=dev)]
    ptrs = [t.data_ptr() for t in scratch] or [None] * 3
    _build.launch("ivf_scan", _fn(), dev, Q.data_ptr(), vecs.data_ptr(),
                  pids.data_ptr(), tile_map.data_ptr(), out_i.data_ptr(),
                  out_d.data_ptr(), *ptrs, nq, T, d, block_rows,
                  n_pad // block_rows, topk, int(raw), plan.splits)
    return out_i, out_d
