"""Kernel dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to its plain PyTorch version in ``kernels.ref``.

Counterpart of ``repro.kernels.ops``.  There is no fallback: a CUDA call
whose kernel fails to build or launch raises.  ``force="ref"`` runs the
plain version on any device; it exists so ``chip_smoke.py`` (and the
kernel-vs-plain parity run) can hold the kernels against it on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import gather_score as _gs
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import refine_merge as _rm


def _use_kernel(t: torch.Tensor, force: Optional[str]) -> bool:
    if force not in (None, "ref"):
        raise ValueError(f"force must be None or 'ref', got {force!r}")
    return force is None and t.is_cuda


def gather_score(x: torch.Tensor, u: torch.Tensor, cand: torch.Tensor,
                 D: torch.Tensor, cnt: torch.Tensor, *, mode: str = "bkm",
                 force: Optional[str] = None) -> torch.Tensor:
    """(B, d) x (B, C) candidate ids -> (B, C) move scores."""
    if _use_kernel(x, force):
        return _gs.gather_score(x, u, cand, D, cnt, mode=mode)
    return _ref.gather_score(x, u, cand, D, cnt, mode=mode)


def refine_merge(x: torch.Tensor, rows: torch.Tensor, cand_ids: torch.Tensor,
                 old_ids: torch.Tensor, old_d: torch.Tensor,
                 Xsrc: torch.Tensor, *, ysq: Optional[torch.Tensor] = None,
                 force: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C) candidate rows merged into (B, κ) top-κ lists."""
    if _use_kernel(x, force):
        return _rm.refine_merge(x, rows, cand_ids, old_ids, old_d, Xsrc,
                                ysq=ysq)
    return _ref.refine_merge(x, rows, cand_ids, old_ids, old_d, Xsrc,
                             ysq=ysq)
