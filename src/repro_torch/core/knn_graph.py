"""KNN graph by iterated fast k-means (paper Alg. 3): shared graph primitives.

Counterpart of ``repro.core.knn_graph``: the ``KnnGraph`` container, random
initial graphs, exact edge distances (``graph_distances``), the sort-based
``merge_topk`` (the κ > 64 refine path), the fixed-capacity member tables
(``members_table``, and ``members_table_local`` with its spill list), and
``build_knn_graph``, a thin adapter over ``core.graph_build.build_graph``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device, to_device

INF = float("inf")


class KnnGraph(NamedTuple):
    ids: torch.Tensor   # (n, κ) int32 neighbour ids, sorted by distance
    dist: torch.Tensor  # (n, κ) float32 squared L2


def random_graph(n: int, kappa: int, generator: torch.Generator, *,
                 own: Optional[torch.Tensor] = None,
                 device: DeviceLike = None) -> torch.Tensor:
    """(m, κ) int32 random neighbour ids in [0, n), each != its row's own id.

    ``own`` (m,): the rows' own ids, default ``arange(n)``; a padded build
    passes its phantom rows' real ids.  All -1 when n == 1.  Drawn from the
    CPU ``generator`` and returned on ``device`` (default ``cuda``; raises
    without one).
    """
    dev = resolve_device(device)
    own = torch.arange(n) if own is None else torch.as_tensor(own).long()
    if n <= 1:
        ids = torch.full((own.shape[0], kappa), -1, dtype=torch.int64)
    else:
        r = torch.randint(0, n - 1, (own.shape[0], kappa),
                          generator=generator)
        ids = torch.where(r >= own[:, None], r + 1, r)
    return to_device(ids.to(torch.int32), dev)


def graph_distances(X: torch.Tensor, ids: torch.Tensor, chunk: int = 4096
                    ) -> torch.Tensor:
    """(n, κ) exact squared distances along the graph's edges.

    Works in row chunks of ``chunk`` only when the chunk divides n and n is
    larger than one chunk; otherwise the whole input is one piece (the
    reference's fallback, owned here so callers pass ``chunk``
    unconditionally).  A -1 id indexes the last row, as in the reference.
    """
    n = ids.shape[0]
    step = chunk if n % chunk == 0 and n > chunk else n
    out = []
    for s in range(0, n, step):
        nb = X[ids[s:s + step].long()].float()           # (c, κ, d)
        diff = nb - X[s:s + step].float()[:, None, :]
        out.append((diff * diff).sum(-1))
    return torch.cat(out)


def merge_topk(g_ids: torch.Tensor, g_d: torch.Tensor, c_ids: torch.Tensor,
               c_d: torch.Tensor, kappa: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate lists into sorted top-κ lists with id-dedupe.

    Three stable argsorts: by distance, by id (equal ids adjacent, best
    first; later copies become inf), by distance again.  -1 ids are invalid.
    """
    ids = torch.cat([g_ids, c_ids], dim=-1).to(torch.int32)
    d = torch.cat([g_d, c_d], dim=-1).float()
    d = torch.where(ids < 0, INF, d)
    o1 = torch.argsort(d, dim=-1, stable=True)
    ids1, d1 = ids.gather(-1, o1), d.gather(-1, o1)
    o2 = torch.argsort(ids1, dim=-1, stable=True)
    ids2, d2 = ids1.gather(-1, o2), d1.gather(-1, o2)
    dup = torch.cat([torch.zeros_like(ids2[..., :1], dtype=torch.bool),
                     ids2[..., 1:] == ids2[..., :-1]], dim=-1)
    d2 = torch.where(dup | (ids2 < 0), INF, d2)
    o3 = torch.argsort(d2, dim=-1, stable=True)
    ids3 = ids2.gather(-1, o3)[..., :kappa]
    d3 = d2.gather(-1, o3)[..., :kappa]
    return torch.where(torch.isinf(d3), -1, ids3).to(torch.int32), d3


def members_table_local(assign: torch.Tensor, pos: torch.Tensor, k: int,
                        cap: int, spill: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged clusters -> fixed-capacity transposed member table + spill list.

    ``assign`` (B,) cluster ids, ``pos`` (B,) global row ids.  Each cluster
    keeps its first ``cap`` members in assignment-stable order; the first
    ``spill`` overflow rows (in the same stable order) form the spill list.
    Returns (table_T (cap, k) int32 with -1 padding, spill (spill,) int32,
    overflow () int32 = every row beyond the caps).
    """
    B = assign.shape[0]
    dev = assign.device
    a = assign.long()
    order = torch.argsort(a, stable=True)
    a_sorted = a[order]
    cnt = torch.zeros((k,), dtype=torch.int64, device=dev)
    cnt.index_add_(0, a, torch.ones_like(a))
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(B, device=dev) - start[a_sorted]
    valid = rank < cap
    gids = pos[order].to(torch.int32)
    slot = torch.where(valid, rank * k + a_sorted, cap * k)
    flat = torch.full((cap * k + 1,), -1, dtype=torch.int32, device=dev)
    flat[slot] = gids
    o_c = torch.clamp(cnt - cap, min=0)
    ovf_rank = (torch.cumsum(o_c, 0) - o_c)[a_sorted] + rank - cap
    sslot = torch.where(~valid & (ovf_rank < spill), ovf_rank, spill)
    sflat = torch.full((spill + 1,), -1, dtype=torch.int32, device=dev)
    sflat[sslot] = gids
    return (flat[:cap * k].view(cap, k), sflat[:spill],
            (~valid).sum(dtype=torch.int32))


def members_table(assign: torch.Tensor, k: int, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged clusters -> (table (k, cap) int32 row ids with -1 padding,
    overflow () int32).

    Each cluster keeps its first ``cap`` members in assignment-stable order;
    members beyond ``cap`` are left out of the table and counted in
    ``overflow``.  ``members_table_local`` over all rows, with no spill list,
    transposed.
    """
    pos = torch.arange(assign.shape[0], device=assign.device)
    table_T, _, overflow = members_table_local(assign, pos, k, cap, 0)
    return table_T.T.contiguous(), overflow


def build_knn_graph(X, kappa: int, *, xi: int = 64, tau: int = 8,
                    generator: Optional[torch.Generator] = None,
                    draws=None, bkm_batch: int = 1024, cap_factor: int = 2,
                    chunk: int = 1024, guided: bool = True,
                    shards: int = 1, force: Optional[str] = None,
                    device: DeviceLike = None,
                    return_diagnostics: bool = False,
                    telemetry: bool = False):
    """Approximate KNN graph by iterated fast k-means (Alg. 3).

    Returns ``KnnGraph`` (n, κ), ids sorted by distance — plus per-round
    ``BuildDiagnostics`` when ``return_diagnostics=True``.  Runs on
    ``device`` (default ``cuda``; raises without one).  Randomness comes from
    ``generator`` (CPU ``torch.Generator``) or the explicit ``draws``
    (``graph_build.BuildDraws``).  ``telemetry=True`` adds per-round rows
    to the diagnostics (``BuildDiagnostics.telemetry``).  ``shards=R``
    emulates an R-way group build on one device (equal to a
    ``GraphBuilder(group=...)`` build over R ranks).
    """
    from repro_torch.core.graph_build import GraphBuildConfig, build_graph
    Xd = as_f32(X, resolve_device(device))
    cfg = GraphBuildConfig(kappa=kappa, source="partition", xi=xi, tau=tau,
                           cap_factor=cap_factor, bkm_batch=bkm_batch,
                           guided=guided, chunk=chunk, shards=shards,
                           force=force, telemetry=telemetry)
    graph, diag = build_graph(Xd, cfg, generator=generator, draws=draws)
    return (graph, diag) if return_diagnostics else graph
