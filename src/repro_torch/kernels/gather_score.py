"""Wrapper of the hand-written CUDA ``gather_score`` kernel.

Counterpart of ``repro.kernels.gather_score`` (the Pallas TPU kernel,
``src/repro/kernels/gather_score.py:64``).  The kernel
(``csrc/gather_score.cu``) scores each sample of a batch against its source
cluster and C candidate clusters without materialising the (B, C+1, d)
gather: a CTA of 8 warps takes two samples, each row goes to a group of
``layout(d).lanes`` lanes, and each row's ``||D_v||²`` is summed from the
gathered row beside ``x·D_v``, so no (k,) norm vector is hoisted.  Its
bound is the unique bytes, with D resident in L2; the gathered rows read at
the L2 rate are the practical floor (``PERF.md`` §6).  This wrapper checks
its inputs, allocates the output and launches on the current stream of the
tensors' device: one device launch and nothing else.  It takes CUDA tensors
only: CPU tensors go to ``kernels.ref.gather_score`` through
``kernels.ops``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# autotune: exempt(gather_score): its row layout (lanes a row, rows a warp,
# samples a CTA) follows d alone (``layout``) and one launch covers the
# batch: there is no host-side plan to tune.

_MODES = {"bkm": 0, "lloyd": 1}
SAMPLES_PER_CTA = 2     # the kernel's kSamples (csrc/gather_score.cu)


class Layout(NamedTuple):
    """How the kernel spreads a sample's rows at width d: ``lanes`` lanes a
    row, ``rows_per_warp`` rows a warp instruction, ``samples_per_cta``
    samples a CTA of 8 warps, and ``slices`` float4 slices of x a lane (0:
    x re-read from L1, d > 1024)."""
    lanes: int
    rows_per_warp: int
    samples_per_cta: int
    slices: int


def layout(d: int) -> Layout:
    """The kernel's row layout at width d: 8 lanes a row up to d=128 (a
    row's 32 float4 slices, 4 a lane), 16 up to 256, else 32; x held in
    the smallest of 1, 2, 4 or 8 slices a lane that covers the row."""
    lanes = 8 if d <= 128 else 16 if d <= 256 else 32
    f4 = -(-d // 4)                     # float4 slices of a row
    need = -(-f4 // lanes)
    slices = next((s for s in (1, 2, 4, 8) if need <= s), 0)
    return Layout(lanes, 32 // lanes, SAMPLES_PER_CTA, slices)


def _fn():
    lib = _build.library("gather_score")
    f = lib.gather_score_launch
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
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
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    lay = layout(d)
    _build.launch("gather_score", _fn(), dev, x.data_ptr(), u.data_ptr(),
                  cand.data_ptr(), D.data_ptr(), cnt.data_ptr(),
                  out.data_ptr(), B, C, d, k, _MODES[mode], lay.lanes,
                  lay.slices)
    return out
