"""Wrapper of the hand-written CUDA ``gather_score`` kernel.

Counterpart of ``repro.kernels.gather_score`` (the Pallas TPU kernel).  The
kernel (``csrc/gather_score.cu``) scores each sample of a batch against its
source cluster and C candidate clusters, one warp per sample, without
materialising the (B, C+1, d) gather.  This wrapper checks its inputs,
hoists the (k,) cluster norms ``||D_k||²``, allocates the output and
launches on the current stream.  It takes CUDA tensors only: CPU tensors go
to ``kernels.ref.gather_score`` through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_MODES = {"bkm": 0, "lloyd": 1}


def _fn():
    lib = _build.library("gather_score")
    f = lib.gather_score_launch
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def gather_score(x: torch.Tensor, u: torch.Tensor, cand: torch.Tensor,
                 D: torch.Tensor, cnt: torch.Tensor, *,
                 mode: str = "bkm") -> torch.Tensor:
    """(B, C) move scores, computed by the CUDA kernel.

    x (B, d) f32; u (B,) int32; cand (B, C) int32 in [0, k); D (k, d) f32;
    cnt (k,) f32 — all contiguous on one CUDA device.  mode='bkm' gives ΔI
    (self-moves not masked), 'lloyd' the centroid distance minus ||x||²
    (+inf for empty clusters).  An id outside [0, k) scores NaN.
    """
    if mode not in _MODES:
        raise ValueError(f"mode must be 'bkm' or 'lloyd', got {mode!r}")
    if x.dim() != 2 or cand.dim() != 2 or D.dim() != 2:
        raise ValueError("x, cand and D must be 2-D")
    B, d = x.shape
    C = cand.shape[1]
    k = D.shape[0]
    dev = x.device
    _build.check_tensor(x, "x", torch.float32, (B, d), dev)
    _build.check_tensor(u, "u", torch.int32, (B,), dev)
    _build.check_tensor(cand, "cand", torch.int32, (B, C), dev)
    _build.check_tensor(D, "D", torch.float32, (k, d), dev)
    _build.check_tensor(cnt, "cnt", torch.float32, (k,), dev)
    dsq = (D * D).sum(-1)                               # (k,) hoisted norms
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    _build.launch("gather_score", _fn(), dev, x.data_ptr(), u.data_ptr(),
                  cand.data_ptr(), D.data_ptr(), cnt.data_ptr(),
                  dsq.data_ptr(), out.data_ptr(), B, C, d, k, _MODES[mode])
    return out
