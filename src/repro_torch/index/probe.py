"""Batched IVF query path: coarse top-p probe -> inverted-list scan.

Counterpart of ``repro.index.probe`` for the per-query f32 layout: each
query probes its ``nprobe`` nearest cells (``probe_centroids``), the cells
become a tile map of packed tiles (``build_tile_map``), and ``ivf_scan``
streams exactly those tiles with a running top-k.  ``search`` syncs the
host zero times: every shape it needs is a plain int of the index.

Not ported yet: the query-grouped layout (``build_group_map``,
``ivf_scan_grouped``), the compressed-list scan (``exact_rerank``,
``ivf_scan_adc``) and the sharded merges (``merge_shard_topk``,
``merge_probe_cells``); ``search(qgroup=G>1)``, ``search(codec=...)`` and
``search(rerank=...)`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._device import as_f32
from repro_torch.index.ivf import IvfIndex
from repro_torch.kernels import ops as kops


def build_tile_map(cids: torch.Tensor, starts: torch.Tensor,
                   caps: torch.Tensor, *, max_tiles: int, block_rows: int,
                   null_tile: int) -> torch.Tensor:
    """Probed cells -> per-query packed-tile indices.

    cids: (q, p) cell ids; returns (q, p * max_tiles) int32, with slots past
    a list's end pointing at the all-hole null tile.
    """
    c = cids.long()
    first = starts.long()[c] // block_rows                  # (q, p)
    ntiles = caps.long()[c] // block_rows                   # (q, p)
    ar = torch.arange(max_tiles, device=cids.device)
    tiles = first[..., None] + ar                           # (q, p, T)
    tiles = torch.where(ar < ntiles[..., None], tiles,
                        torch.full_like(tiles, null_tile))
    return tiles.reshape(cids.shape[0], cids.shape[1] * max_tiles).to(
        torch.int32)


def _no_candidates(q: int, topk: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The empty-index result: -1 / +inf everywhere."""
    return (torch.full((q, topk), -1, dtype=torch.int32, device=device),
            torch.full((q, topk), float("inf"), device=device))


def search(index: IvfIndex, Q, *, topk: int = 10, nprobe: int = 8,
           force: Optional[str] = None, qgroup: Optional[int] = None,
           codec: str = "f32", rerank: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k search.  Q: (q, d) -> (ids (q, topk) int32, d2 (q, topk) f32).

    ids are the original vector ids (-1 past the candidate count); d2 is
    the exact squared L2 to them.  ``nprobe`` clamps to the cell count.
    ``force="ref"`` runs the kernels' plain versions.  Q is moved to the
    index's device (no copy when it is already a float32 tensor there).
    ``rerank`` belongs to the compressed-list scan, which is not ported yet:
    passing it raises.
    """
    if codec != "f32" or rerank is not None:
        raise NotImplementedError(
            f"search(codec={codec!r}, rerank={rerank}): the compressed-list "
            "scan is not "
            "ported yet (ROADMAP.md, item 1.9b: ivf_scan_adc, exact_rerank)")
    if qgroup is not None and qgroup > 1:
        raise NotImplementedError(
            "search(qgroup=...): the query-grouped scan is not ported yet "
            "(ROADMAP.md, item 1.9b: build_group_map, ivf_scan_grouped)")
    if nprobe < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    Q = as_f32(Q, index.device)
    nprobe = min(nprobe, index.k)
    if index.max_list_tiles == 0:         # every list empty: nothing to scan
        return _no_candidates(Q.shape[0], topk, index.device)
    cids, _ = kops.probe_centroids(Q, index.centroids, nprobe, force=force)
    tm = build_tile_map(cids, index.starts, index.caps,
                        max_tiles=index.max_list_tiles,
                        block_rows=index.block_rows,
                        null_tile=index.null_tile)
    return kops.ivf_scan(Q, index.vecs, index.ids, tm,
                         block_rows=index.block_rows, topk=topk, force=force)


def scan_fraction(index: IvfIndex, Q, *, nprobe: int = 8,
                  force: Optional[str] = None) -> float:
    """Mean fraction of packed database rows streamed per query (a host
    diagnostic: syncs once)."""
    Q = as_f32(Q, index.device)
    nprobe = min(nprobe, index.k)
    cids, _ = kops.probe_centroids(Q, index.centroids, nprobe, force=force)
    scanned = index.caps.long()[cids.long()].sum(-1).double()  # (q,)
    return float(scanned.mean() / max(index.capacity_rows, 1))


def exhaustive_search(index: IvfIndex, Q, *, topk: int = 10,
                      force: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth scan of every packed tile, through the same scan
    kernel — for recall evaluation, and a check of the scan's padding
    handling against brute force."""
    Q = as_f32(Q, index.device)
    ntiles = index.capacity_rows // index.block_rows
    if ntiles == 0:                       # every list empty: nothing to scan
        return _no_candidates(Q.shape[0], topk, index.device)
    tm = torch.arange(ntiles, dtype=torch.int32, device=index.device)
    tm = tm.expand(Q.shape[0], ntiles).contiguous()
    return kops.ivf_scan(Q, index.vecs, index.ids, tm,
                         block_rows=index.block_rows, topk=topk, force=force)

