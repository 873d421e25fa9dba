"""Wrappers of the hand-written CUDA ``assign_centroids`` and
``probe_centroids`` kernels.

Counterparts of ``repro.kernels.centroid_assign`` (the Pallas TPU kernels).
The kernels (``csrc/centroid_assign.cu``) stream the centroids past
128-row tiles of X with register-blocked FP32 products and keep a running
(min, argmin), or a running sorted top-p, per row, without materialising
the (n, k) distance matrix.  These wrappers check their inputs, hoist
``||c||²`` and ``||x||²`` once per call, allocate the outputs and launch on
the current stream.  They take CUDA tensors only: CPU tensors go to
``kernels.ref`` through ``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_P = 128     # the probe kernel's largest list (csrc/centroid_assign.cu)


def _fn(name: str, nints: int):
    f = getattr(_build.library("centroid_assign"), name)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * nints
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


def assign_centroids(X: torch.Tensor, C: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(assign (n,) int32, d2 (n,) f32), computed by the CUDA kernel.

    X (n, d) f32 and C (k, d) f32, contiguous on one CUDA device, k >= 1.
    assign is the first minimum of ``||c||² − 2x·c`` (ties to the lower
    index); d2 = ``max(min + ||x||², 0)``.
    """
    n, k, d = _check(X, C)
    if k < 1:
        raise ValueError("need at least one centroid")
    csq, xsq = _norms(X, C)
    out_i = torch.empty((n,), dtype=torch.int32, device=X.device)
    out_d = torch.empty((n,), dtype=torch.float32, device=X.device)
    if n == 0:
        return out_i, out_d
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _fn("assign_centroids_launch", 3)(
        X.data_ptr(), C.data_ptr(), csq.data_ptr(), xsq.data_ptr(),
        out_i.data_ptr(), out_d.data_ptr(), n, k, d, stream)
    if rc != 0:
        raise RuntimeError(f"assign_centroids launch failed: CUDA error {rc}")
    _build.launch_counts["assign_centroids"] += 1
    return out_i, out_d


def probe_centroids(X: torch.Tensor, C: torch.Tensor, p: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (n, p) int32, d2 (n, p) f32), computed by the CUDA kernel.

    The p nearest centroids of each row, ascending by ``||c||² − 2x·c``
    with ties to the lower index; d2 = ``max(part + ||x||², 0)``.
    1 <= p <= min(k, 128).
    """
    n, k, d = _check(X, C)
    if not 1 <= p <= min(k, MAX_P):
        raise ValueError(f"need 1 <= p <= min(k, {MAX_P}), got p={p}, k={k}")
    csq, xsq = _norms(X, C)
    out_i = torch.empty((n, p), dtype=torch.int32, device=X.device)
    out_d = torch.empty((n, p), dtype=torch.float32, device=X.device)
    if n == 0:
        return out_i, out_d
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _fn("probe_centroids_launch", 4)(
        X.data_ptr(), C.data_ptr(), csq.data_ptr(), xsq.data_ptr(),
        out_i.data_ptr(), out_d.data_ptr(), n, k, d, p, stream)
    if rc != 0:
        raise RuntimeError(f"probe_centroids launch failed: CUDA error {rc}")
    _build.launch_counts["probe_centroids"] += 1
    return out_i, out_d
