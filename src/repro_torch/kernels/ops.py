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

from repro_torch.kernels import assign_centroids as _ac
from repro_torch.kernels import centroid_assign as _ca
from repro_torch.kernels import gather_score as _gs
from repro_torch.kernels import ivf_scan as _ivf
from repro_torch.kernels import ivf_scan_adc as _adc
from repro_torch.kernels import ivf_scan_grouped as _grp
from repro_torch.kernels import pairwise_sq as _pw
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


def assign_centroids(X: torch.Tensor, C: torch.Tensor, *,
                     force: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, d) x (k, d) -> nearest centroid (assign (n,), d2 (n,))."""
    if _use_kernel(X, force):
        return _ac.assign_centroids(X, C)
    return _ref.assign_centroids(X, C)


def probe_centroids(X: torch.Tensor, C: torch.Tensor, p: int, *,
                    force: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, d) x (k, d) -> top-p nearest centroids (ids (n, p), d2 (n, p))."""
    if _use_kernel(X, force):
        return _ca.probe_centroids(X, C, p)
    return _ref.probe_centroids(X, C, p)


def ivf_scan(Q: torch.Tensor, vecs: torch.Tensor, pids: torch.Tensor,
             tile_map: torch.Tensor, *, block_rows: int, topk: int = 10,
             force: Optional[str] = None, raw: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query scan of probed packed-list tiles -> (ids, d2) top-k."""
    if _use_kernel(Q, force):
        return _ivf.ivf_scan(Q, vecs, pids, tile_map, block_rows=block_rows,
                             topk=topk, raw=raw)
    return _ref.ivf_scan(Q, vecs, pids, tile_map, block_rows=block_rows,
                         topk=topk, raw=raw)


def ivf_scan_grouped(Qg: torch.Tensor, vecs: torch.Tensor,
                     pids: torch.Tensor, union_tiles: torch.Tensor,
                     qmask: torch.Tensor, *, block_rows: int, topk: int = 10,
                     force: Optional[str] = None, raw: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-grouped scan: each union tile read once per group of queries
    -> (ids, d2) top-k in grouped order."""
    if _use_kernel(Qg, force):
        return _grp.ivf_scan_grouped(Qg, vecs, pids, union_tiles, qmask,
                                     block_rows=block_rows, topk=topk,
                                     raw=raw)
    return _ref.ivf_scan_grouped(Qg, vecs, pids, union_tiles, qmask,
                                 block_rows=block_rows, topk=topk, raw=raw)


def ivf_scan_adc(lut: torch.Tensor, qconst: torch.Tensor,
                 vnorm: torch.Tensor, codes: torch.Tensor,
                 pids: torch.Tensor, tile_map: torch.Tensor, *,
                 block_rows: int, topk: int = 10,
                 force: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric-distance scan of compressed lists through a per-query
    table -> (ids, packed-row pos, raw partials) top-k."""
    if _use_kernel(lut, force):
        return _adc.ivf_scan_adc(lut, qconst, vnorm, codes, pids, tile_map,
                                 block_rows=block_rows, topk=topk)
    return _ref.ivf_scan_adc(lut, qconst, vnorm, codes, pids, tile_map,
                             block_rows=block_rows, topk=topk)


def pairwise_sq(Xb: torch.Tensor, *, force: Optional[str] = None
                ) -> torch.Tensor:
    """Batched (B, m, d) -> (B, m, m) squared L2, float32 out; Xb float32
    or bfloat16.  The reference's ``tile=`` and ``force="pallas"`` /
    ``"interpret"`` are TPU knobs and have no counterpart here."""
    if _use_kernel(Xb, force):
        return _pw.pairwise_sq(Xb)
    return _ref.pairwise_sq(Xb)
