"""Wrapper of the hand-written CUDA ``ivf_scan_grouped`` kernel.

Counterpart of ``repro.kernels.ivf_scan.ivf_scan_grouped`` (the Pallas TPU
kernel).  The kernel (``csrc/ivf_scan_grouped.cu``) runs one CTA per group
of G queries: the group walks its deduped union of probed tiles once, each
query scores only the slots its ``qmask`` marks, and each keeps its own
running top-k.  This wrapper checks its inputs, allocates the outputs and
launches on the current stream.  It takes CUDA tensors only: CPU tensors go
to ``kernels.ref.ivf_scan_grouped`` through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_TOPK = 1024     # the kernel's largest list (csrc/common.cuh)
MAX_GROUP = 8       # queries per group: one merging warp each


def _fn():
    f = _build.library("ivf_scan_grouped").ivf_scan_grouped_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def ivf_scan_grouped(Qg: torch.Tensor, vecs: torch.Tensor,
                     pids: torch.Tensor, union_tiles: torch.Tensor,
                     qmask: torch.Tensor, *, block_rows: int, topk: int = 10,
                     raw: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, d2), each (ngroups·G, topk) in grouped order, computed by the
    CUDA kernel.

    Qg (ngroups·G, d) f32 queries permuted into groups
    (``index.probe.build_group_map``); vecs (n_pad, d) f32; pids (n_pad,)
    int32, -1 at holes; union_tiles (ngroups, U) int32; qmask (ngroups·G,
    U) int32, nonzero where the query probed the slot — all contiguous on
    one CUDA device.  d2 as ``ivf_scan``'s (``raw=True``: the partials).
    1 <= G <= 8 and 1 <= topk <= 1024.
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn()(Qg.data_ptr(), vecs.data_ptr(), pids.data_ptr(),
               union_tiles.data_ptr(), qmask.data_ptr(), out_i.data_ptr(),
               out_d.data_ptr(), ngroups, G, U, d, block_rows,
               n_pad // block_rows, topk, int(raw), stream)
    if rc != 0:
        raise RuntimeError(f"ivf_scan_grouped launch failed: CUDA error {rc}")
    _build.launch_counts["ivf_scan_grouped"] += 1
    return out_i, out_d
