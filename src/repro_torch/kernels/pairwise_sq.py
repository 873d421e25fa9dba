"""Wrapper of the hand-written CUDA ``pairwise_sq`` kernel.

Counterpart of ``repro.kernels.pairwise_topk.pairwise_sq`` (the Pallas TPU
kernel).  The kernel (``csrc/pairwise_sq.cu``) runs one CTA per cluster and
unordered pair of 64-row tiles (``tile_pair``), computes each element of
the symmetric (m, m) matrix once and writes it to both of its places:
float32 input on FP32 FMAs in 8x8 register blocks (no TF32), bfloat16 input
on the tensor cores (``mma.sync``; bf16 products are exact in f32), row
norms summed from the staged rows.  This wrapper checks its input,
allocates the output and launches on the current stream.  It takes CUDA
tensors only: CPU tensors go to ``kernels.ref.pairwise_sq`` through
``kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# autotune: exempt(pairwise_sq): one CTA a tile pair, tiles fixed at compile
# time (f32 FMAs, bf16 mma.sync); the grid is the pair count: there is no
# host-side plan to tune.

TILE = 64                # output tile edge of the kernel (csrc/pairwise_sq.cu)
INT_MAX = 2**31 - 1      # gridDim.x takes B * pair_count(nt) <= B * nt**2;
                         # d is a C int


def pair_count(nt: int) -> int:
    """Unordered tile pairs (ti <= tj) of nt tiles: the CTAs a cluster
    takes."""
    return nt * (nt + 1) // 2


def tile_pair(p: int, nt: int):
    """The pair (ti, tj), ti <= tj, of linear index p: row-major over the
    upper triangle, as ``pair_of`` in ``csrc/pairwise_sq.cu`` (which also
    maps a diagonal tile's 8x8 blocks, nt = 8, and the bf16 path's 16x16
    blocks, nt = 4)."""
    ti = 0
    while p >= nt - ti:
        p -= nt - ti
        ti += 1
    return ti, ti + p


def _fn():
    f = _build.library("pairwise_sq").pairwise_sq_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def pairwise_sq(Xb: torch.Tensor) -> torch.Tensor:
    """(B, m, m) float32 squared L2 within each cluster, computed by the
    CUDA kernel.

    Xb: contiguous (B, m, d) float32 or bfloat16 on a CUDA device; any
    B, m, d.  ``D[b,i,j] = max(||x_i||² + ||x_j||² − 2 x_i·x_j, 0)`` in f32.
    """
    if Xb.dim() != 3:
        raise ValueError(f"Xb must be 3-D (B, m, d), got {Xb.dim()}-D")
    if Xb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Xb: expected float32 or bfloat16, got {Xb.dtype}")
    B, m, d = Xb.shape
    _build.check_tensor(Xb, "Xb", Xb.dtype, (B, m, d), Xb.device)
    tiles = -(-m // TILE)
    if B * tiles * tiles > INT_MAX or d > INT_MAX:
        raise ValueError(f"Xb {tuple(Xb.shape)}: more than {INT_MAX} output "
                         "tiles or features")
    out = torch.empty((B, m, m), dtype=torch.float32, device=Xb.device)
    if B == 0 or m == 0:
        return out
    _build.launch("pairwise_sq", _fn(), Xb.device, Xb.data_ptr(),
                  out.data_ptr(), B, m, d, int(Xb.dtype == torch.bfloat16))
    return out
