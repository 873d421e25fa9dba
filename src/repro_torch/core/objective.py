"""Clustering objectives for boost k-means / GK-means (``repro.core.objective``).

The boost k-means objective (paper Eqn. 2) is ``I = sum_r ||D_r||² / n_r``
with ``D_r`` the sum of cluster r's members; the k-means distortion (paper
Eqn. 4) is ``(sum_i ||x_i||² − I) / n``.  Statistics are float32.  Segment
sums are ``index_add_`` (atomic on CUDA: D is order-dependent in the last
ulp; the counts are integer-valued and exact below 2**24).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class ClusterStats(NamedTuple):
    D: torch.Tensor    # (k, d) float32 composite vectors
    cnt: torch.Tensor  # (k,) float32 counts


def cluster_stats(X: torch.Tensor, assign: torch.Tensor,
                  k: int) -> ClusterStats:
    """(D, cnt) from an assignment vector."""
    Xf = X.float()
    a = assign.long()
    D = torch.zeros((k, Xf.shape[1]), dtype=torch.float32, device=X.device)
    D.index_add_(0, a, Xf)
    cnt = torch.zeros((k,), dtype=torch.float32, device=X.device)
    cnt.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
    return ClusterStats(D, cnt)


def centroids(stats: ClusterStats) -> torch.Tensor:
    """C_r = D_r / n_r (zero for empty clusters)."""
    return stats.D / torch.clamp(stats.cnt, min=1.0)[:, None]


def objective_I(stats: ClusterStats) -> torch.Tensor:
    """Boost k-means objective I = sum_r ||D_r||² / n_r."""
    sq = (stats.D * stats.D).sum(-1)
    return torch.where(stats.cnt > 0, sq / torch.clamp(stats.cnt, min=1.0),
                       torch.zeros_like(sq)).sum()


def distortion(X: torch.Tensor, assign: torch.Tensor, k: int) -> torch.Tensor:
    """Average distortion E (paper Eqn. 4) = (sum ||x||² − I) / n."""
    stats = cluster_stats(X, assign, k)
    xsq = (X.float() ** 2).sum()
    return (xsq - objective_I(stats)) / X.shape[0]


def delta_I(x: torch.Tensor, D_u: torch.Tensor, n_u: torch.Tensor,
            D_v: torch.Tensor, n_v: torch.Tensor) -> torch.Tensor:
    """Paper Eqn. 3: objective change of moving x from cluster u to each v.

    x, D_u (..., d); n_u (...,); D_v (..., C, d); n_v (..., C).  Returns
    (..., C).  When n_u == 1 the source cluster empties and its residual
    term ``||D_u - x||² / (n_u - 1)`` is 0.
    """
    x, D_u, D_v = x.float(), D_u.float(), D_v.float()
    xsq = (x * x).sum(-1)
    du_sq = (D_u * D_u).sum(-1)
    dv_sq = (D_v * D_v).sum(-1)
    x_du = (x * D_u).sum(-1)
    x_dv = (x[..., None, :] * D_v).sum(-1)
    # target gain: ||D_v + x||²/(n_v+1) - ||D_v||²/n_v
    gain_v = (dv_sq + 2.0 * x_dv + xsq[..., None]) / (n_v + 1.0)
    gain_v = gain_v - torch.where(n_v > 0, dv_sq / torch.clamp(n_v, min=1.0),
                                  torch.zeros_like(dv_sq))
    # source loss: ||D_u - x||²/(n_u-1) - ||D_u||²/n_u
    num_u = du_sq - 2.0 * x_du + xsq
    resid = torch.where(n_u > 1, num_u / torch.clamp(n_u - 1.0, min=1.0),
                        torch.zeros_like(num_u))
    loss_u = resid - du_sq / torch.clamp(n_u, min=1.0)
    return gain_v + loss_u[..., None]


def delta_I_brute(X: torch.Tensor, assign: torch.Tensor, k: int, i: int,
                  v: int) -> torch.Tensor:
    """Oracle of ``delta_I``: I(sample i moved to cluster v) − I(before),
    recomputed from scratch in O(n·d)."""
    moved = assign.clone()
    moved[i] = v
    return (objective_I(cluster_stats(X, moved, k))
            - objective_I(cluster_stats(X, assign, k)))


def assignment_distortion(X: torch.Tensor, C: torch.Tensor, block: int = 2048
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact nearest-centroid assignment + mean distortion, blocked over rows.

    Returns (assign (n,) int32, mean distortion ()).
    """
    Cf = C.float()
    csq = (Cf * Cf).sum(-1)
    assign, best = [], []
    for s in range(0, X.shape[0], block):
        xb = X[s:s + block].float()
        d2 = csq[None, :] - 2.0 * (xb @ Cf.T)
        m, a = d2.min(dim=-1)
        assign.append(a.to(torch.int32))
        best.append(m + (xb * xb).sum(-1))
    best = torch.cat(best)
    return torch.cat(assign), torch.clamp(best, min=0.0).mean()
