"""Batched IVF query path: coarse top-p probe -> inverted-list scan.

Counterpart of ``repro.index.probe``.  Each query probes its ``nprobe``
nearest cells (``probe_centroids``), the cells become a tile map of packed
tiles (``build_tile_map``), and one of three scans streams exactly those
tiles with a running top-k:

* per-query f32 (default): ``ivf_scan``, one query at a time;
* query-grouped (``qgroup=G``): queries are sorted into probe-local groups
  of G (``build_group_map``) and each group walks its deduped union of
  tiles once (``ivf_scan_grouped``).  The ids equal the per-query scan's
  whenever distances are distinct; at exactly equal distances candidates
  resolve in ascending tile order here, in probe order there;
* compressed lists (``codec="int8"|"pq"``): ``ivf_scan_adc`` over the u8
  code slab through a per-query table, then ``exact_rerank`` re-scores the
  top ``rerank`` candidates against the f32 rows.

``search`` syncs the host zero times on every path: each shape it needs is
a plain int of the index or of the query count.  ``merge_shard_topk`` and
``merge_probe_cells`` merge per-shard results (``core.distributed.
ShardedIvf``) with the kernels' first-minimum tie order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._device import as_f32
from repro_torch.index import quantize as _q
from repro_torch.index.ivf import IvfIndex
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

INF = float("inf")


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


def build_group_map(tile_map: torch.Tensor, *, group: int, null_tile: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query tile map -> probe-local query groups with union tiles.

    Sorts the queries (stably) by their first probed tile, takes groups of
    ``group`` consecutive queries, and dedupes each group's probed tiles
    into one sorted union (real tiles ascending, null-tile padding last).
    Returns (order (ngroups·G,) int32 — the query of each grouped row, q at
    the ragged tail's padding rows; union (ngroups, G·T) int32; qmask
    (ngroups·G, G·T) int32, 1 where the row's query probed the union slot,
    0 on padding rows and null slots).  Integer work only, equal to
    ``repro.index.probe.build_group_map``; no host sync.
    """
    q, T = tile_map.shape
    G = group
    npad = (-q) % G
    dev = tile_map.device
    order = torch.argsort(tile_map[:, 0], stable=True).to(torch.int32)
    valid = torch.ones((q,), dtype=torch.bool, device=dev)
    if npad:
        order = torch.cat([order, torch.full((npad,), q, dtype=torch.int32,
                                             device=dev)])
        valid = torch.cat([valid, torch.zeros((npad,), dtype=torch.bool,
                                              device=dev)])
    ngroups = (q + npad) // G
    U = G * T
    tq = tile_map[order.clamp(max=q - 1).long()]           # (qg, T)
    tq = torch.where(valid[:, None], tq, null_tile)
    flat = tq.reshape(ngroups, U)
    # dedupe each group's tiles: null sorts (and dupes are re-marked) last
    big = torch.iinfo(torch.int32).max
    srt = torch.sort(torch.where(flat == null_tile, big, flat), dim=-1).values
    dup = torch.cat([torch.zeros_like(srt[:, :1], dtype=torch.bool),
                     srt[:, 1:] == srt[:, :-1]], dim=-1)
    srt = torch.sort(torch.where(dup, big, srt), dim=-1).values
    union = torch.where(srt == big, null_tile, srt).to(torch.int32)
    # membership: a real tile's left insertion slot in its sorted union is
    # its (unique) union slot; null entries never join the mask
    slot = torch.searchsorted(union, flat.to(torch.int32).contiguous())
    real = (flat != null_tile).to(torch.int32)
    member = torch.arange(U, device=dev) // T              # member per entry
    row = torch.arange(ngroups, device=dev)[:, None] * G + member[None, :]
    at = row * U + slot.clamp(max=U - 1)
    memb = torch.zeros((ngroups * G * U,), dtype=torch.int32, device=dev)
    memb.scatter_reduce_(0, at.reshape(-1), real.reshape(-1), reduce="amax")
    return order, union, memb.reshape(ngroups * G, U)


def _no_candidates(q: int, topk: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The empty-index result: -1 / +inf everywhere."""
    return (torch.full((q, topk), -1, dtype=torch.int32, device=device),
            torch.full((q, topk), INF, device=device))


def exact_rerank(Q: torch.Tensor, vecs: torch.Tensor, pids: torch.Tensor,
                 pos: torch.Tensor, *, topk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-score of ADC survivors (the rerank tail), no decode.

    Q (q, d); vecs (n_pad, d) the f32 rows; pids (n_pad,) int32; pos (q, R)
    packed row positions from ``ivf_scan_adc`` (-1 = empty).  Gathers the
    f32 rows by position, scores them ``||v||² − 2q·v`` as the f32 scan
    does, and selects topk with the first-minimum rule.  Returns (ids (q,
    topk), raw partials, +inf at empty slots) for ``finalize_d2``.
    """
    safe = pos.clamp(min=0).long()
    cv = vecs[safe].float()                                # (q, R, d)
    vsq = (cv * cv).sum(-1)
    dots = torch.einsum("qd,qrd->qr", Q.float(), cv)
    cids = torch.where(pos < 0, -1, pids[safe])
    part = torch.where(cids < 0, INF, vsq - 2.0 * dots)
    d, ids = kref.stable_topk(part, cids, topk)
    return ids, torch.where(ids < 0, INF, d)


def _rerank_depth(topk: int, rerank: Optional[int]) -> int:
    """Candidate depth of the ADC pass: 0 disables the rerank tail."""
    if rerank is None:
        return 4 * topk
    if rerank == 0:
        return 0
    return max(rerank, topk)


def _search_grouped(index: IvfIndex, Q: torch.Tensor, tm: torch.Tensor, *,
                    topk: int, qgroup: int, force: Optional[str]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = Q.shape[0]
    order, union, qmask = build_group_map(tm, group=qgroup,
                                          null_tile=index.null_tile)
    Qg = Q[order.clamp(max=q - 1).long()]
    gi, gd = kops.ivf_scan_grouped(Qg, index.vecs, index.ids, union, qmask,
                                   block_rows=index.block_rows, topk=topk,
                                   force=force)
    # back to the query order: padding rows carry index q, so scatter into
    # q + 1 rows and drop the last (a negative sentinel would wrap)
    ids = torch.full((q + 1, topk), -1, dtype=torch.int32, device=Q.device)
    d2 = torch.full((q + 1, topk), INF, device=Q.device)
    ids[order.long()] = gi
    d2[order.long()] = gd
    return ids[:q], d2[:q]


def _search_codec(index: IvfIndex, Q: torch.Tensor, tm: torch.Tensor, *,
                  topk: int, rerank: Optional[int], force: Optional[str]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    depth = _rerank_depth(topk, rerank)
    lut, qc = _q.build_lut(index.codec, Q)
    ids, pos, part = kops.ivf_scan_adc(
        lut, qc, index.vnorm, index.codes, index.ids, tm,
        block_rows=index.block_rows, topk=depth or topk, force=force)
    if depth:
        ids, part = exact_rerank(Q, index.vecs, index.ids, pos, topk=topk)
    return kref.finalize_d2(ids, part, Q)


def search(index: IvfIndex, Q, *, topk: int = 10, nprobe: int = 8,
           force: Optional[str] = None, qgroup: Optional[int] = None,
           codec: str = "f32", rerank: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k search.  Q: (q, d) -> (ids (q, topk) int32, d2 (q, topk) f32).

    ids are the original vector ids (-1 past the candidate count); d2 is
    the exact squared L2 to them.  ``nprobe`` clamps to the cell count.
    ``force="ref"`` runs the kernels' plain versions.  Q is moved to the
    index's device (no copy when it is already a float32 tensor there).

    ``qgroup=G`` (G > 1) runs the query-grouped scan.  ``codec="pq"|"int8"``
    scans the attached compressed payload (per-query layout only; the codec
    must be the index's, else ``ValueError``), then exact-reranks the top
    ``rerank`` candidates against the f32 rows (default 4·topk; ``rerank=0``
    returns distances to the reconstructions instead).  ``rerank`` is read
    only with a codec.
    """
    if nprobe < 1:
        raise ValueError(f"nprobe must be >= 1, got {nprobe}")
    if codec != "f32":
        if qgroup is not None and qgroup > 1:
            raise ValueError("the codec scan is per-query only (no qgroup)")
        if index.codec_kind != codec:
            raise ValueError(f"search(codec={codec!r}) on an index whose "
                             f"payload is {index.codec_kind!r}")
    Q = as_f32(Q, index.device)
    nprobe = min(nprobe, index.k)
    if index.max_list_tiles == 0:         # every list empty: nothing to scan
        return _no_candidates(Q.shape[0], topk, index.device)
    cids, _ = kops.probe_centroids(Q, index.centroids, nprobe, force=force)
    tm = build_tile_map(cids, index.starts, index.caps,
                        max_tiles=index.max_list_tiles,
                        block_rows=index.block_rows,
                        null_tile=index.null_tile)
    if codec != "f32":
        return _search_codec(index, Q, tm, topk=topk, rerank=rerank,
                             force=force)
    if qgroup is not None and qgroup > 1:
        return _search_grouped(index, Q, tm, topk=topk, qgroup=qgroup,
                               force=force)
    return kops.ivf_scan(Q, index.vecs, index.ids, tm,
                         block_rows=index.block_rows, topk=topk, force=force)


def merge_shard_topk(ids: torch.Tensor, part: torch.Tensor, topk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard local top-k lists into the global top-k.

    ids/part: (R, q, t) gathered shard results, ``part`` the raw partial
    distances (+inf, id -1 at empty slots).  A packed row lives on one
    shard, so no id dedupe is needed; the selection is ``stable_topk`` over
    the candidates in shard order — the scan kernels' first-minimum tie
    order.  Returns (ids (q, topk), part (q, topk)), still raw.
    """
    R, q, t = ids.shape
    ent_i = ids.permute(1, 0, 2).reshape(q, R * t)
    ent_d = part.permute(1, 0, 2).reshape(q, R * t)
    d, i = kref.stable_topk(ent_d, ent_i, topk)
    return i, d


def merge_probe_cells(gd: torch.Tensor, gi: torch.Tensor, p: int
                      ) -> torch.Tensor:
    """Merge per-shard coarse-probe lists into the global top-p cells.

    gd/gi: (L, q) gathered per-shard probe values (+inf at slab holes) and
    global cell ids, L = R · p_loc in shard-major order.  Selects by
    iterated first minimum over L, as the reference does
    (``kernels.ref.first_min_merge``).  Returns cids (q, p) int32.
    """
    return kref.first_min_merge(gd, gi, p).to(torch.int32)


def scan_fraction(index: IvfIndex, Q, *, nprobe: int = 8,
                  force: Optional[str] = None) -> float:
    """Mean fraction of packed database rows streamed per query (a host
    diagnostic: syncs once)."""
    Q = as_f32(Q, index.device)
    nprobe = min(nprobe, index.k)
    cids, _ = kops.probe_centroids(Q, index.centroids, nprobe, force=force)
    scanned = index.caps.long()[cids.long()].sum(-1).double()  # (q,)
    # lint: boundary(a host diagnostic: one read by design)
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

