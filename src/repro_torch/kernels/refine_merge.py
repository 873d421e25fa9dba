"""Wrapper of the hand-written CUDA ``refine_merge`` kernel.

Counterpart of ``repro.kernels.refine_merge`` (the Pallas TPU kernel).  The
kernel (``csrc/refine_merge.cu``) computes each row's exact squared
distances to its C candidate rows of ``Xsrc`` and merges them into the row's
sorted, id-deduped top-κ list, one CTA per row, without materialising the
(B, C, d) gather or the (B, C) distance matrix: the κ-pass merge is done as
a stable sort by (distance, position), a first-occurrence test per id and a
prefix-sum compaction.  This wrapper checks its inputs, takes (or computes)
the hoisted source norms, allocates the outputs and launches on the current
stream of the tensors' device.  It takes CUDA tensors only: CPU tensors go
to ``kernels.ref.refine_merge`` through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# autotune: exempt(refine_merge): one CTA a row, its register sort sized at
# compile time; the grid is the batch: there is no host-side plan to tune.

MAX_L = 4096    # κ + C the kernel merges in shared memory, at most

def _fn():
    lib = _build.library("refine_merge")
    f = lib.refine_merge_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong, ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def source_norms(Xsrc: torch.Tensor) -> torch.Tensor:
    """(N,) ``||y||²`` of every source row — hoist once per source."""
    return (Xsrc * Xsrc).sum(-1)


def refine_merge(x: torch.Tensor, rows: torch.Tensor, cand_ids: torch.Tensor,
                 old_ids: torch.Tensor, old_d: torch.Tensor,
                 Xsrc: torch.Tensor, *, ysq: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (B, κ) int32, d (B, κ) f32), computed by the CUDA kernel.

    x (B, d) f32; rows (B, C) int32 indices into Xsrc; cand_ids (B, C)
    int32 (-1 = invalid); old_ids (B, κ) int32 / old_d (B, κ) f32 sorted
    lists; Xsrc (N, d) f32; ysq (N,) f32 = ``source_norms(Xsrc)`` (computed
    here when omitted).  A candidate whose row lies outside [0, N) is
    treated as invalid.  κ + C <= 4096.
    """
    if x.dim() != 2 or rows.dim() != 2 or old_ids.dim() != 2:
        raise ValueError("x, rows and old_ids must be 2-D")
    B, d = x.shape
    C = rows.shape[1]
    kappa = old_ids.shape[1]
    N = Xsrc.shape[0]
    if kappa + C > MAX_L:
        raise ValueError(f"kappa + C = {kappa + C} exceeds the kernel's "
                         f"{MAX_L} merged entries per row")
    dev = x.device
    _build.check_tensor(x, "x", torch.float32, (B, d), dev)
    _build.check_tensor(rows, "rows", torch.int32, (B, C), dev)
    _build.check_tensor(cand_ids, "cand_ids", torch.int32, (B, C), dev)
    _build.check_tensor(old_ids, "old_ids", torch.int32, (B, kappa), dev)
    _build.check_tensor(old_d, "old_d", torch.float32, (B, kappa), dev)
    _build.check_tensor(Xsrc, "Xsrc", torch.float32, (N, d), dev)
    if ysq is None:
        ysq = source_norms(Xsrc)
    _build.check_tensor(ysq, "ysq", torch.float32, (N,), dev)
    out_i = torch.empty((B, kappa), dtype=torch.int32, device=dev)
    out_d = torch.empty((B, kappa), dtype=torch.float32, device=dev)
    if B == 0 or kappa == 0:
        return out_i, out_d
    _build.launch("refine_merge", _fn(), dev, x.data_ptr(), rows.data_ptr(),
                  cand_ids.data_ptr(), old_ids.data_ptr(), old_d.data_ptr(),
                  Xsrc.data_ptr(), ysq.data_ptr(), out_i.data_ptr(),
                  out_d.data_ptr(), B, C, kappa, d, N)
    return out_i, out_d
