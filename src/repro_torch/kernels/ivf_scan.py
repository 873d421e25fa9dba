"""Wrapper of the hand-written CUDA ``ivf_scan`` kernel.

Counterpart of ``repro.kernels.ivf_scan.ivf_scan`` (the Pallas TPU kernel).
The kernel (``csrc/ivf_scan.cu``) walks each query's probed tiles of the
packed database, one CTA per query, reads only live rows and merges every
tile into a running top-k in shared memory.  This wrapper checks its
inputs, allocates the outputs and launches on the current stream.  It takes
CUDA tensors only: CPU tensors go to ``kernels.ref.ivf_scan`` through
``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_TOPK = 1024     # the kernel's largest list (csrc/ivf_scan.cu)


def _fn():
    f = _build.library("ivf_scan").ivf_scan_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
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
    ``raw=True`` (+inf at -1 slots).  1 <= topk <= 1024.
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
    dev = Q.device
    _build.check_tensor(Q, "Q", torch.float32, (nq, d), dev)
    _build.check_tensor(vecs, "vecs", torch.float32, (n_pad, d), dev)
    _build.check_tensor(pids, "pids", torch.int32, (n_pad,), dev)
    _build.check_tensor(tile_map, "tile_map", torch.int32, (nq, T), dev)
    out_i = torch.empty((nq, topk), dtype=torch.int32, device=dev)
    out_d = torch.empty((nq, topk), dtype=torch.float32, device=dev)
    if nq == 0:
        return out_i, out_d
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn()(Q.data_ptr(), vecs.data_ptr(), pids.data_ptr(),
               tile_map.data_ptr(), out_i.data_ptr(), out_d.data_ptr(), nq, T,
               d, block_rows, n_pad // block_rows, topk, int(raw), stream)
    if rc != 0:
        raise RuntimeError(f"ivf_scan launch failed: CUDA error {rc}")
    _build.launch_counts["ivf_scan"] += 1
    return out_i, out_d
