"""Plain PyTorch versions of the main path's kernels.

Counterparts of ``repro.kernels.ref`` (``scores_from_dots``,
``gather_score``, ``merge_lists``, ``refine_merge``).  They run on any
device: ``kernels.ops`` sends CPU tensors here, and ``chip_smoke.py`` holds
the CUDA kernels against them on the card (``force="ref"``).  Every op is
elementwise per row or a batched product, so a batch may be cut anywhere.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

INF = float("inf")


def scores_from_dots(dots: torch.Tensor, nv: torch.Tensor, dsq: torch.Tensor,
                     xsq: torch.Tensor, mode: str) -> torch.Tensor:
    """Move scores from inner products (``repro.kernels.ref.scores_from_dots``).

    dots/nv/dsq: (B, C+1), slot 0 the source cluster u and slots 1..C the
    candidates (x·D[row], cnt[row], ||D[row]||²); xsq: (B,).  mode='bkm'
    gives ΔI (paper Eqn. 3, self-moves not masked); mode='lloyd' gives the
    candidate-centroid distance minus ||x||², +inf for empty clusters.
    """
    nv_c, dsq_c, xd_c = nv[:, 1:], dsq[:, 1:], dots[:, 1:]
    if mode == "lloyd":
        inv = 1.0 / torch.clamp(nv_c, min=1.0)
        d2 = dsq_c * (inv * inv) - 2.0 * (xd_c * inv)
        return torch.where(nv_c > 0, d2, torch.full_like(d2, INF))
    if mode != "bkm":
        raise ValueError(f"mode must be 'bkm' or 'lloyd', got {mode!r}")
    nu, dsq_u, xd_u = nv[:, 0], dsq[:, 0], dots[:, 0]
    gain = (dsq_c + 2.0 * xd_c + xsq[:, None]) / (nv_c + 1.0)
    gain = gain - torch.where(nv_c > 0, dsq_c / torch.clamp(nv_c, min=1.0),
                              torch.zeros_like(dsq_c))
    num_u = dsq_u - 2.0 * xd_u + xsq
    resid = torch.where(nu > 1, num_u / torch.clamp(nu - 1.0, min=1.0),
                        torch.zeros_like(num_u))
    loss_u = resid - dsq_u / torch.clamp(nu, min=1.0)
    return gain + loss_u[:, None]


def gather_dots(x: torch.Tensor, rows: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``dots[i, j] = x[i] · src[rows[i, j]]`` through a (B, R, d) gather."""
    G = src[rows.long()]                                   # (B, R, d)
    return torch.bmm(G, x.unsqueeze(2)).squeeze(2)


def gather_score(x: torch.Tensor, u: torch.Tensor, cand: torch.Tensor,
                 D: torch.Tensor, cnt: torch.Tensor, *,
                 mode: str = "bkm") -> torch.Tensor:
    """Candidate-move scores (``repro.kernels.ref.gather_score``).

    x (B, d) f32; u (B,) int32 source clusters; cand (B, C) int32 candidate
    clusters; D (k, d) f32 composite vectors; cnt (k,) f32 counts -> (B, C).
    """
    xf = x.float()
    Df = D.float()
    rows = torch.cat([u[:, None], cand], dim=1).long()     # (B, C+1)
    dsq_k = (Df * Df).sum(-1)                              # (k,)
    dots = gather_dots(xf, rows, Df)
    nv = cnt.float()[rows]
    dsq = dsq_k[rows]
    xsq = (xf * xf).sum(-1)
    return scores_from_dots(dots, nv, dsq, xsq, mode)


def score_scale(x: torch.Tensor, u: torch.Tensor, cand: torch.Tensor,
                D: torch.Tensor, cnt: torch.Tensor, *,
                mode: str = "bkm") -> torch.Tensor:
    """(B, C) sum of the magnitudes of the terms each move score adds up.

    ΔI is a small difference of large terms (``||D_v||²/(n_v+1)`` against
    ``||D_v||²/n_v``, and so on), so the rounding error of a score scales
    with these terms, not with the score.  ``|x·D_row|`` is bounded by
    ``||x||·||D_row||`` (Cauchy–Schwarz).  A kernel-vs-plain limit is a small
    multiple of this scale, element by element.
    """
    xf, Df = x.float(), D.float()
    rows = torch.cat([u[:, None], cand], dim=1).long()
    dsq = (Df * Df).sum(-1)[rows]
    nv = cnt.float()[rows]
    xsq = (xf * xf).sum(-1)[:, None]
    m = torch.sqrt(dsq * xsq)                  # bounds |x·D_row|
    nv_c, dsq_c, m_c = nv[:, 1:], dsq[:, 1:], m[:, 1:]
    if mode == "lloyd":
        inv = 1.0 / torch.clamp(nv_c, min=1.0)
        return dsq_c * (inv * inv) + 2.0 * m_c * inv
    if mode != "bkm":
        raise ValueError(f"mode must be 'bkm' or 'lloyd', got {mode!r}")
    nu, dsq_u, m_u = nv[:, :1], dsq[:, :1], m[:, :1]
    zero = torch.zeros_like(dsq_c)
    gain = (dsq_c + 2.0 * m_c + xsq) / (nv_c + 1.0) + torch.where(
        nv_c > 0, dsq_c / torch.clamp(nv_c, min=1.0), zero)
    resid = torch.where(nu > 1, (dsq_u + 2.0 * m_u + xsq)
                        / torch.clamp(nu - 1.0, min=1.0), zero[:, :1])
    return gain + resid + dsq_u / torch.clamp(nu, min=1.0)


def merge_lists(old_ids: torch.Tensor, old_d: torch.Tensor,
                cand_ids: torch.Tensor, cd: torch.Tensor, kappa: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-κ merge with id-dedupe (``repro.kernels.ref.merge_lists``).

    κ passes of first-minimum selection over the concatenated
    ``[old, cand]`` entries; each pass retires every copy of the selected id.
    Entries with id -1 count as +inf; exhausted slots come out -1/inf.
    """
    ent_d = torch.cat([old_d.float(), cd.float()], dim=-1)
    ent_i = torch.cat([old_ids, cand_ids], dim=-1).to(torch.int32)
    ent_d = torch.where(ent_i < 0, torch.full_like(ent_d, INF), ent_d)
    L = ent_d.shape[-1]
    col = torch.arange(L, device=ent_d.device)[None, :]
    out_d, out_i = [], []
    for _ in range(kappa):
        mv = ent_d.min(dim=-1).values                      # (B,)
        hit = ent_d == mv[:, None]
        pos = torch.where(hit, col, L).min(dim=-1).values  # first minimum
        at = col == pos[:, None]
        sid = torch.where(at, ent_i, 0).sum(dim=-1, dtype=torch.int32)
        valid = mv < INF
        out_d.append(torch.where(valid, mv, INF))
        out_i.append(torch.where(valid, sid, -1))
        ent_d = torch.where((ent_i == sid[:, None]) | at, INF, ent_d)
    return (torch.stack(out_i, dim=-1).to(torch.int32),
            torch.stack(out_d, dim=-1))


def refine_merge(x: torch.Tensor, rows: torch.Tensor, cand_ids: torch.Tensor,
                 old_ids: torch.Tensor, old_d: torch.Tensor,
                 Xsrc: torch.Tensor, *, ysq: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate distances merged into top-κ lists (``repro.kernels.ref``).

    x (B, d); rows (B, C) int32 indices into Xsrc (pre-clamped >= 0);
    cand_ids (B, C) int32 ids, -1 = invalid; old_ids/old_d (B, κ) sorted
    lists; Xsrc (N, d); ysq (N,) the hoisted ``||Xsrc||²`` (computed here
    when omitted).  Distances are ``max(||y||² + ||x||² − 2x·y, 0)``.
    """
    kappa = old_ids.shape[1]
    xf = x.float()
    Xf = Xsrc.float()
    r = rows.long()
    if ysq is None:
        ysq = (Xf * Xf).sum(-1)
    ysq_c = ysq[r]                                         # (B, C)
    xsq = (xf * xf).sum(-1)
    dots = gather_dots(xf, r, Xf)
    cd = torch.clamp(ysq_c + xsq[:, None] - 2.0 * dots, min=0.0)
    return merge_lists(old_ids.to(torch.int32), old_d, cand_ids, cd, kappa)
