"""Graph-quality metrics: brute-force ground truth + recall (paper §5.1).

Counterpart of ``repro.core.recall``.
"""
from __future__ import annotations

from typing import Optional

import torch


def brute_force_knn(X: torch.Tensor, kappa: int, chunk: int = 1024, *,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact top-κ neighbour ids (self excluded), int32, in full float32.

    ``rows`` (q,) restricts the queries to those rows of X (ground truth for
    a sample of a large X); default all n rows.  O(q·n·d).
    """
    Xf = X.float()
    sq = (Xf * Xf).sum(-1)
    q_rows = (torch.arange(X.shape[0], device=X.device) if rows is None
              else rows.to(X.device).long())
    out = []
    for s in range(0, q_rows.shape[0], chunk):
        own = q_rows[s:s + chunk]
        xb = Xf[own]
        d2 = (xb * xb).sum(-1)[:, None] + sq[None, :] - 2.0 * (xb @ Xf.T)
        d2[torch.arange(own.shape[0], device=X.device), own] = float("inf")
        out.append(torch.topk(d2, kappa, dim=1, largest=False).indices)
    return torch.cat(out).to(torch.int32)


def recall_at(ids: torch.Tensor, gt: torch.Tensor, at: int) -> torch.Tensor:
    """|top-at of graph ∩ top-at of truth| / at, averaged over samples."""
    hits = (ids[:, :at, None] == gt[:, None, :at]).any(-1)
    return hits.float().mean()


def _mean0(hits: torch.Tensor) -> torch.Tensor:
    """Share of True along axis 0, as XLA takes a float32 mean: the (exact)
    count times the float32 reciprocal of the row count."""
    return hits.float().sum(dim=0) * (1.0 / hits.shape[0])


def recall_top1(ids: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The paper's metric: share of samples whose true 1-NN appears anywhere
    in their κ list.  gt: (n, >= 1) exact neighbour ids."""
    return _mean0((ids == gt[:, :1]).any(dim=1))


def cooccurrence_rate(assign: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Fig. 1: P(a sample and its j-th true NN share a cluster), per j.

    Returns (gt.shape[1],) rates."""
    a = assign.long()
    return _mean0(a[gt.long()] == a[:, None])
