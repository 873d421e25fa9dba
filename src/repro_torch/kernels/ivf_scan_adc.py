"""Wrapper of the hand-written CUDA ``ivf_scan_adc`` kernel.

Counterpart of ``repro.kernels.ivf_scan_adc.ivf_scan_adc`` (the Pallas TPU
kernel, ``src/repro/kernels/ivf_scan_adc.py:76``).  The kernels
(``csrc/ivf_scan_adc.cu``) split and merge as ``ivf_scan``'s do, on the
same plan (``ivf_scan.split_plan``: each query's live slots in S chunks in
slot order, ``ivf_scan.live_slots`` and ``ivf_scan.slot_chunks`` say
which): a CTA per chunk copies the query's distance table into shared
memory while it finds its live slots, scores only live rows, keeps one
sorted list per warp of packed row positions and merges them by (value,
candidate position); when S > 1 a second pass merges each query's S lists
in chunk order.  The last pass writes the finished row: positions, ids
gathered by position and the partials plus the query constant.  The bound
is the bytes of the live rows' codes and norms and each query's table
(``PERF.md`` §6).  This wrapper checks its inputs, allocates the outputs and
the scratch, and launches on the current stream of the tensors' device: one
or two device launches and no PyTorch op after them.  It takes CUDA tensors
only: CPU tensors go to ``kernels.ref.ivf_scan_adc`` through
``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import INT_MAX, split_plan

# autotune: exempt(ivf_scan_adc): CTAS_PER_SM, the one knob of its split
# plan (``ivf_scan.split_plan``), gives one plan for every candidate
# (2-32) at 1,000 queries or more, and at the served batch (64 queries,
# nprobe 16) no candidate beat today's 8 by more than the spread between
# rounds in two sweeps on the H100: the table would hold nothing for it.

MAX_TOPK = 1024         # the kernel's largest list (csrc/common.cuh)
MAX_LUT_FLOATS = 32768  # M·W floats of table in shared memory (128 KiB)


def _fn():
    f = _build.library("ivf_scan_adc").ivf_scan_adc_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def ivf_scan_adc(lut: torch.Tensor, qconst: torch.Tensor,
                 vnorm: torch.Tensor, codes: torch.Tensor,
                 pids: torch.Tensor, tile_map: torch.Tensor, *,
                 block_rows: int, topk: int = 10
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ids, pos, part), each (q, topk), computed by the CUDA kernel.

    lut (q, M, W) f32 and qconst (q,) f32 (``index.quantize.build_lut``);
    vnorm (n_pad,) f32; codes (n_pad, M) uint8; pids (n_pad,) int32, -1 at
    holes; tile_map (q, T) int32 — all contiguous on one CUDA device, n_pad
    a multiple of block_rows.  Returns ids (-1 at empty slots), the packed
    row positions (-1 at empty slots) and the raw partials plus qconst
    (+inf at empty slots).  1 <= topk <= 1024; M·W <= 32,768.  One or two
    device launches (``split_plan``); the launch count adds one per call.
    """
    if lut.dim() != 3 or codes.dim() != 2 or tile_map.dim() != 2:
        raise ValueError("lut must be 3-D, codes and tile_map 2-D")
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"need 1 <= topk <= {MAX_TOPK}, got {topk}")
    nq, m, w = lut.shape
    if m * w > MAX_LUT_FLOATS:
        raise ValueError(f"the table of M*W = {m * w} floats exceeds the "
                         f"kernel's {MAX_LUT_FLOATS} in shared memory")
    n_pad = codes.shape[0]
    if block_rows < 1 or n_pad % block_rows:
        raise ValueError(f"n_pad {n_pad} is not a multiple of block_rows "
                         f"{block_rows}")
    T = tile_map.shape[1]
    if max(T * block_rows, n_pad) > INT_MAX:
        raise ValueError(f"T * block_rows = {T * block_rows} candidates per "
                         f"query or n_pad = {n_pad} rows exceed the "
                         f"kernel's {INT_MAX} positions")
    dev = lut.device
    _build.check_tensor(lut, "lut", torch.float32, (nq, m, w), dev)
    _build.check_tensor(qconst, "qconst", torch.float32, (nq,), dev)
    _build.check_tensor(vnorm, "vnorm", torch.float32, (n_pad,), dev)
    _build.check_tensor(codes, "codes", torch.uint8, (n_pad, m), dev)
    _build.check_tensor(pids, "pids", torch.int32, (n_pad,), dev)
    _build.check_tensor(tile_map, "tile_map", torch.int32, (nq, T), dev)
    ids = torch.empty((nq, topk), dtype=torch.int32, device=dev)
    pos = torch.empty((nq, topk), dtype=torch.int32, device=dev)
    part = torch.empty((nq, topk), dtype=torch.float32, device=dev)
    if nq == 0:
        return ids, pos, part
    plan = split_plan(nq, T, topk, _build.sm_count(dev.index))
    scratch = []
    if plan.splits > 1:
        scratch = [
            torch.empty((nq, plan.splits, topk), dtype=torch.float32,
                        device=dev),
            torch.empty((nq, plan.splits, topk), dtype=torch.int32,
                        device=dev)]
    ptrs = [t.data_ptr() for t in scratch] or [None] * 2
    _build.launch("ivf_scan_adc", _fn(), dev, lut.data_ptr(),
                  vnorm.data_ptr(), codes.data_ptr(), pids.data_ptr(),
                  tile_map.data_ptr(), qconst.data_ptr(), ids.data_ptr(),
                  pos.data_ptr(), part.data_ptr(), *ptrs, nq, T, m, w,
                  block_rows, n_pad // block_rows, topk, plan.splits)
    return ids, pos, part
