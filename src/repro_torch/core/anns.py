"""Approximate nearest-neighbour search over a KNN graph (paper §4.3).

Counterpart of ``repro.core.anns``: greedy best-first search with a
fixed-size pool, batched over queries in plain PyTorch (the reference vmaps
one query's search).  The pool starts as the best ``ef`` of ``8·ef`` random
beacons; each round expands the best unvisited pool entry's κ neighbours and
stable-sorts the merged list back to ``ef``.  No host sync.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device, to_device


def graph_search(X, ids, queries, topk: int = 10, ef: int = 32,
                 iters: int = 24, *,
                 generator: Optional[torch.Generator] = None, beacons=None,
                 device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (q, topk) int32, d2 (q, topk)) of each query's best pool entries.

    ``ids`` (n, κ) the graph (-1 ids read as row 0, as in the reference);
    ``beacons`` (q, 8·ef) each query's random entry rows, drawn from
    ``generator`` (a CPU ``torch.Generator``) when omitted.  Ties keep the
    reference's order: every sort is stable and the best unvisited entry is
    the first minimum.
    """
    dev = resolve_device(device)
    Xf = as_f32(X, dev)
    Q = as_f32(queries, dev)
    G = torch.clamp(to_device(torch.as_tensor(ids), dev).long(), min=0)
    n, kappa = G.shape
    q = Q.shape[0]
    if beacons is None:
        if generator is None:
            raise ValueError("pass beacons or a generator")
        beacons = torch.randint(0, n, (q, 8 * ef), generator=generator)
    cand0 = to_device(torch.as_tensor(beacons).long(), dev)

    def dist(rows):                                        # (q, m)
        diff = Xf[rows] - Q[:, None, :]
        return (diff * diff).sum(-1)

    d0, o0 = torch.sort(dist(cand0), dim=1, stable=True)
    pool_id, pool_d = cand0.gather(1, o0[:, :ef]), d0[:, :ef]
    pool_vis = torch.zeros((q, ef), dtype=torch.bool, device=dev)
    fresh = torch.zeros((q, kappa), dtype=torch.bool, device=dev)
    for _ in range(iters):
        b = torch.where(pool_vis, float("inf"), pool_d).argmin(1, True)
        pool_vis.scatter_(1, b, True)
        nbrs = G[pool_id.gather(1, b)[:, 0]]               # (q, κ)
        dup = (nbrs[:, :, None] == pool_id[:, None, :]).any(-1)
        nd = torch.where(dup, float("inf"), dist(nbrs))
        all_d, o = torch.sort(torch.cat([pool_d, nd], 1), dim=1, stable=True)
        o = o[:, :ef]
        pool_id = torch.cat([pool_id, nbrs], 1).gather(1, o)
        pool_d = all_d[:, :ef]
        pool_vis = torch.cat([pool_vis, fresh], 1).gather(1, o)
    d, o = torch.sort(pool_d, dim=1, stable=True)
    return pool_id.gather(1, o[:, :topk]).to(torch.int32), d[:, :topk]
