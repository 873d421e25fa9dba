"""Wrapper of the hand-written CUDA ``ivf_scan_grouped`` kernel.

Counterpart of ``repro.kernels.ivf_scan.ivf_scan_grouped`` (the Pallas TPU
kernel).  The kernels (``csrc/ivf_scan_grouped.cu``) split and merge: each
group of G queries walks its deduped union of probed tiles once, each query
scores only the slots its ``qmask`` marks and keeps its own running top-k,
and ``split_plan`` cuts each group's union into S contiguous slot chunks
(``slot_chunks``), one CTA each; when S > 1 a second pass merges each
query's S partial lists in chunk order (strict insert, so the reference's
slot-then-row order holds).  This wrapper checks its inputs, allocates the
outputs and the scratch, and launches on the current stream.  It takes
CUDA tensors only: CPU tensors go to ``kernels.ref.ivf_scan_grouped``
through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, autotune

MAX_TOPK = 1024     # the kernel's largest list (csrc/common.cuh)
MAX_GROUP = 8       # queries per group: one merging warp each
MIN_SLOTS = 4       # union slots per chunk, at the least
CTAS_PER_SM = 2     # the split's target: this many CTAs per SM
MAX_MERGE = 32_768  # candidates one merging warp takes per row, at most


class ScanPlan(NamedTuple):
    """How ``ivf_scan_grouped`` splits its work: each group's union in
    ``splits`` chunks of ``chunk`` slots (of the full width U; the kernel
    cuts the live span the same way, ``slot_chunks``), ``ctas`` CTAs in
    pass 1."""
    splits: int
    chunk: int
    ctas: int


def split_plan(ngroups: int, U: int, topk: int, sms: int,
               ctas_per_sm: int = CTAS_PER_SM) -> ScanPlan:
    """The grouped scan's split of ngroups unions of U slots over ``sms``
    SMs (``ctas_per_sm``: the autotune table's knob).

    Pure host arithmetic (no device read).  One chunk per group once the
    groups alone fill the card (ngroups >= sms); else enough chunks for
    about ``ctas_per_sm`` CTAs per SM, each at least ``MIN_SLOTS`` slots of
    U and at most ``MAX_MERGE`` merged candidates per row, evened out.
    """
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"need 1 <= topk <= {MAX_TOPK}, got {topk}")
    splits = 1
    if 0 < ngroups < sms:
        splits = max(1, min(-(-ctas_per_sm * sms // ngroups),
                            U // MIN_SLOTS, MAX_MERGE // topk))
    per = max(1, -(-U // splits))
    splits = max(1, -(-U // per))
    return ScanPlan(splits, per, ngroups * splits)


def slot_chunks(qmask: torch.Tensor, G: int, splits: int) -> torch.Tensor:
    """(ngroups, splits + 1) int64 bounds: chunk s of group g is union slots
    [b[g, s], b[g, s+1]).

    The kernel's own cut, on any device: a group's live span ends after the
    last slot that any of its queries probed (the null-tile padding sorts
    last and is never probed), and splits into ceil(span / splits) slots a
    chunk, in slot order.
    """
    nqg, U = qmask.shape
    probed = (qmask.reshape(nqg // G, G, U) != 0).any(1)
    last = torch.where(probed, torch.arange(1, U + 1, device=qmask.device),
                       0)
    span = last.max(1).values if U else torch.zeros(
        nqg // G, dtype=torch.int64, device=qmask.device)
    per = (span + splits - 1) // splits
    s = torch.arange(splits + 1, device=qmask.device)
    return torch.minimum(s[None, :] * per[:, None], span[:, None])


def _fn():
    f = _build.library("ivf_scan_grouped").ivf_scan_grouped_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def ivf_scan_grouped(Qg: torch.Tensor, vecs: torch.Tensor,
                     pids: torch.Tensor, union_tiles: torch.Tensor,
                     qmask: torch.Tensor, *, block_rows: int, topk: int = 10,
                     raw: bool = False, ctas_per_sm: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, d2), each (ngroups·G, topk) in grouped order, computed by the
    CUDA kernels.

    Qg (ngroups·G, d) f32 queries permuted into groups
    (``index.probe.build_group_map``); vecs (n_pad, d) f32; pids (n_pad,)
    int32, -1 at holes; union_tiles (ngroups, U) int32; qmask (ngroups·G,
    U) int32, nonzero where the query probed the slot — all contiguous on
    one CUDA device.  d2 as ``ivf_scan``'s (``raw=True``: the partials).
    1 <= G <= 8 and 1 <= topk <= 1024.  One or two device launches
    (``split_plan``, its ``ctas_per_sm`` from the autotune table unless
    given); the launch count adds one per call.
    """
    if Qg.dim() != 2 or vecs.dim() != 2 or union_tiles.dim() != 2:
        raise ValueError("Qg, vecs and union_tiles must be 2-D")
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"need 1 <= topk <= {MAX_TOPK}, got {topk}")
    nqg, d = Qg.shape
    ngroups, U = union_tiles.shape
    if (ngroups == 0) != (nqg == 0) or (ngroups and nqg % ngroups):
        raise ValueError(f"{nqg} queries do not split into {ngroups} groups")
    G = nqg // ngroups if ngroups else 1
    if G > MAX_GROUP:
        raise ValueError(f"need G <= {MAX_GROUP} queries per group, got {G}")
    n_pad = vecs.shape[0]
    if block_rows < 1 or n_pad % block_rows:
        raise ValueError(f"n_pad {n_pad} is not a multiple of block_rows "
                         f"{block_rows}")
    dev = Qg.device
    _build.check_tensor(Qg, "Qg", torch.float32, (nqg, d), dev)
    _build.check_tensor(vecs, "vecs", torch.float32, (n_pad, d), dev)
    _build.check_tensor(pids, "pids", torch.int32, (n_pad,), dev)
    _build.check_tensor(union_tiles, "union_tiles", torch.int32,
                        (ngroups, U), dev)
    _build.check_tensor(qmask, "qmask", torch.int32, (nqg, U), dev)
    out_i = torch.empty((nqg, topk), dtype=torch.int32, device=dev)
    out_d = torch.empty((nqg, topk), dtype=torch.float32, device=dev)
    if ngroups == 0:
        return out_i, out_d
    cps = autotune.resolve("ivf_scan_grouped", autotune.BACKEND,
                           {"q": nqg, "U": U, "topk": topk}, ctas_per_sm)
    plan = split_plan(ngroups, U, topk, _build.sm_count(dev.index), cps)
    scratch = []
    if plan.splits > 1:
        scratch = [
            torch.empty((nqg, plan.splits, topk), dtype=torch.float32,
                        device=dev),
            torch.empty((nqg, plan.splits, topk), dtype=torch.int32,
                        device=dev),
            torch.empty((nqg,), dtype=torch.float32, device=dev)]
    ptrs = [t.data_ptr() for t in scratch] or [None] * 3
    _build.launch("ivf_scan_grouped", _fn(), dev, Qg.data_ptr(),
                  vecs.data_ptr(), pids.data_ptr(), union_tiles.data_ptr(),
                  qmask.data_ptr(), out_i.data_ptr(), out_d.data_ptr(),
                  *ptrs, ngroups, G, U, d, block_rows, n_pad // block_rows,
                  topk, int(raw), plan.splits)
    return out_i, out_d
