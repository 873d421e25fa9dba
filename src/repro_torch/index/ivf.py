"""IVF index structure: GK-means centroids + tile-aligned inverted lists.

Counterpart of ``repro.index.ivf``, with the same layout row for row.
Vectors are packed list by list into a flat (n_rows, d) buffer whose rows
are grouped in tiles of ``block_rows`` (the scan kernel's block).  List c
owns rows [starts[c], starts[c] + caps[c]), caps[c] a multiple of
block_rows.  Rows whose id is -1 are holes (alignment padding, tombstones
from ``remove``, room for ``add``); one extra all-hole tile at the end is
the null target of tile-map padding.

The reference keeps its control plane in numpy; here the same work runs as
torch ops on the index's device, so ``add`` never copies the slab to the
host and no step loops over the k lists in Python.  The pack, the repack
and the overflow test of ``add`` sync the host (they size new buffers);
``search`` never does: ``max_list_tiles`` is a plain int fixed at pack time.
Every function returns a new index and leaves its argument as it was.

An index may carry a compressed payload (``index/quantize.py``): ``codes``
and ``vnorm`` mirror ``vecs`` row for row, ``codes == encode(vecs)`` (the
lockstep rule), so every path that rewrites ``vecs`` re-encodes the same
rows: a hole-filling ``add`` encodes exactly the rows it wrote, on the
device; an overflowing ``add`` and ``repack`` re-attach the codec;
``remove`` only tombstones ids and leaves the codes as they are.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device
from repro_torch.index import quantize as _q
from repro_torch.kernels import ops as kops


@dataclass(frozen=True)
class IvfIndex:
    centroids: torch.Tensor   # (k, d) float32 coarse quantizer
    vecs: torch.Tensor        # (n_rows, d) packed vectors (holes = zeros)
    ids: torch.Tensor         # (n_rows,) int32 original ids, -1 = hole
    starts: torch.Tensor      # (k,) int32 row offset per list (tile-aligned)
    caps: torch.Tensor        # (k,) int32 row capacity per list
    block_rows: int           # rows per scan tile
    max_list_tiles: int       # max(caps) // block_rows, fixed at pack time
    repack_threshold: float = 0.5   # repack when live/capacity falls below
    # optional compressed payload, row for row with vecs (the lockstep rule)
    codec: Optional[_q.Codec] = None
    codes: Optional[torch.Tensor] = None   # (n_rows, code_width) uint8
    vnorm: Optional[torch.Tensor] = None   # (n_rows,) f32 ||decode(codes)||²

    @classmethod
    def from_arrays(cls, centroids, vecs, ids, starts, caps, block_rows: int,
                    repack_threshold: float = 0.5, codec=None, codes=None,
                    vnorm=None) -> "IvfIndex":
        """The index over packed tensors (all on one device), with
        ``max_list_tiles`` read from ``caps`` (syncs the host once)."""
        biggest = int(caps.max()) if caps.numel() else 0
        return cls(centroids, vecs, ids, starts, caps, int(block_rows),
                   biggest // int(block_rows), float(repack_threshold),
                   codec, codes, vnorm)

    def to(self, device: DeviceLike) -> "IvfIndex":
        """The same index with every tensor on ``device`` (e.g. an index
        loaded with ``load_index(mmap=True)``, moved to the card)."""
        dev = resolve_device(device)

        def move(t):
            return None if t is None else t.to(dev)
        return replace(self, centroids=move(self.centroids),
                       vecs=move(self.vecs), ids=move(self.ids),
                       starts=move(self.starts), caps=move(self.caps),
                       codec=None if self.codec is None
                       else self.codec.to(dev),
                       codes=move(self.codes), vnorm=move(self.vnorm))

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def n_rows(self) -> int:
        """Total packed rows, including the trailing null tile."""
        return self.vecs.shape[0]

    @property
    def capacity_rows(self) -> int:
        """Rows owned by lists (excludes the null tile)."""
        return self.n_rows - self.block_rows

    @property
    def null_tile(self) -> int:
        return self.capacity_rows // self.block_rows

    @property
    def codec_kind(self) -> str:
        """Codec of the packed payload: 'f32' when uncompressed."""
        return "f32" if self.codec is None else self.codec.kind

    @property
    def size(self) -> int:
        """Number of live vectors (syncs the host)."""
        return int((self.ids >= 0).sum())

    def list_sizes(self) -> torch.Tensor:
        """(k,) int32 live entries per list (prefix sums, no loop)."""
        P = torch.zeros(self.n_rows + 1, dtype=torch.int64,
                        device=self.device)
        P[1:] = torch.cumsum((self.ids >= 0).to(torch.int64), 0)
        s = self.starts.long()
        return (P[s + self.caps.long()] - P[s]).to(torch.int32)


def _row_lists(index: IvfIndex, rows: torch.Tensor) -> torch.Tensor:
    """The list owning each of ``rows`` (< capacity_rows), int64.  A list
    with no rows ends where it starts, so it never owns one."""
    ends = (index.starts.long() + index.caps.long()).contiguous()
    return torch.searchsorted(ends, rows, right=True)


def _align(x: torch.Tensor, m: int) -> torch.Tensor:
    return (x + m - 1) // m * m


def _pack(X: torch.Tensor, ids: torch.Tensor, assign: torch.Tensor,
          centroids: torch.Tensor, k: int, block_rows: int,
          repack_threshold: float) -> IvfIndex:
    """Pack (X, ids, assign) into the tile-aligned layout, on X's device.

    Rows of a list keep their order in the input (a stable sort by list),
    as the reference's ``_pack`` does.  Syncs the host twice: to size the
    buffer, and for ``max_list_tiles``.
    """
    dev = X.device
    n, d = X.shape
    assign = assign.to(device=dev, dtype=torch.int64)
    counts = torch.bincount(assign, minlength=k)
    caps = _align(counts, block_rows)
    starts = torch.cumsum(caps, 0) - caps
    n_rows = int(caps.sum()) + block_rows          # + null tile
    order = torch.argsort(assign, stable=True)
    a_sorted = assign[order]
    first = torch.cumsum(counts, 0) - counts       # rank 0 of each list
    rank = torch.arange(n, device=dev) - first[a_sorted]
    rows = starts[a_sorted] + rank
    vecs = torch.zeros((n_rows, d), dtype=torch.float32, device=dev)
    pids = torch.full((n_rows,), -1, dtype=torch.int32, device=dev)
    vecs[rows] = X[order].float()
    pids[rows] = ids.to(device=dev, dtype=torch.int32)[order]
    return IvfIndex.from_arrays(as_f32(centroids, dev), vecs, pids,
                                starts.to(torch.int32), caps.to(torch.int32),
                                block_rows, repack_threshold)


def build_ivf(X, result, *, block_rows: int = 128,
              repack_threshold: float = 0.5,
              device: DeviceLike = None) -> IvfIndex:
    """Build the index from data X (n, d) and a clustering of it.

    ``result`` is a ``repro_torch.core.gkmeans.GKMeansResult`` (or anything
    with ``.assign`` (n,), ``.centroids`` (k, d), ``.k``): the GK-means
    output becomes the coarse quantizer and the inverted lists in one pass.
    Runs on ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU).
    """
    dev = resolve_device(device)
    X = as_f32(X, dev)
    ids = torch.arange(X.shape[0], dtype=torch.int32, device=dev)
    assign = torch.as_tensor(result.assign).to(dev)
    return _pack(X, ids, assign, result.centroids, int(result.k), block_rows,
                 repack_threshold)


def _gather_live(index: IvfIndex
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(X, ids, assign) of all live entries, in packed order."""
    rows = torch.nonzero(index.ids >= 0, as_tuple=True)[0]
    return index.vecs[rows], index.ids[rows], _row_lists(index, rows)


def attach_codec(index: IvfIndex, codec: _q.Codec) -> IvfIndex:
    """Encode the whole slab with ``codec`` (moved to the index's device).

    Re-attaching after a layout change keeps ``codes == encode(vecs)``; the
    coarse quantizer and the f32 rows stay: they serve the probe and the
    exact-rerank tail.
    """
    codec = codec.to(index.device)
    codes, vnorm = _q.pack_codes(codec, index.vecs)
    return replace(index, codec=codec, codes=codes, vnorm=vnorm)


def quantize_index(index: IvfIndex, kind: str, *, nsub: int = 8,
                   generator: Optional[torch.Generator] = None,
                   iters: int = 8) -> IvfIndex:
    """Train a codec on the index's live rows and attach it.

    kind='int8' fits the per-dimension affine; kind='pq' trains ``nsub``
    sub-codebooks with the engine's own k-means (``quantize.train_pq``,
    drawing from ``generator``, default seed 0).
    """
    X_live, _, _ = _gather_live(index)
    if kind == "int8":
        codec = _q.train_int8(X_live)
    elif kind == "pq":
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        codec = _q.train_pq(X_live, nsub, generator=generator, iters=iters)
    else:
        raise ValueError(f"unknown codec kind: {kind!r}")
    return attach_codec(index, codec)


class ShardedLists(NamedTuple):
    """Per-shard re-pack of an index's inverted lists, by cell
    (``repro.index.ivf.ShardedLists``, array for array).

    Shard r owns the slab ``[r·rows_loc, (r+1)·rows_loc)`` of the stacked
    rows: its cells' lists back to back, hole rows up to the common size,
    and a trailing local null tile; and the start/cap table ``[r·k,
    (r+1)·k)``, whose unowned cells have cap 0 (a local tile map sends
    their probes to the null tile).
    """
    vecs: torch.Tensor       # (R * rows_loc, d)
    ids: torch.Tensor        # (R * rows_loc,) int32, -1 = hole
    starts: torch.Tensor     # (R * k,) int32 local row offsets (0 unowned)
    caps: torch.Tensor       # (R * k,) int32 local caps, 0 for unowned cells
    owner: torch.Tensor      # (k,) int64 (CPU) the shard owning each cell
    rows_loc: int            # rows a shard holds, its null tile included
    shards: int
    codes: Optional[torch.Tensor] = None   # (R * rows_loc, width) uint8
    vnorm: Optional[torch.Tensor] = None   # (R * rows_loc,) f32


def shard_lists(index: IvfIndex, shards: int) -> ShardedLists:
    """Partition the packed lists across ``shards`` by cell.

    Cells go greedily, by descending capacity (ties by cell id), to the
    least-loaded shard (ties to the lowest shard), so a shard's slab holds
    little beyond the largest shard's rows even when ``k % shards != 0`` or
    the lists are skewed — the reference's loop.  The owner map is built on
    the host (one read of ``caps``); the rows move in one scatter on the
    index's device.  Codes and norms move with their rows.
    """
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    dev = index.device
    bl, k, R = index.block_rows, index.k, shards
    caps_h = index.caps.long().cpu()
    owner = torch.zeros((k,), dtype=torch.int64)
    heap = [(0, r) for r in range(R)]          # (load, shard): a min-heap
    for c in torch.argsort(-caps_h, stable=True).tolist():
        load, r = heapq.heappop(heap)
        owner[c] = r
        heapq.heappush(heap, (load + int(caps_h[c]), r))
    loads = torch.zeros((R,), dtype=torch.int64).index_add_(0, owner, caps_h)
    rows_loc = int(loads.max()) + bl                 # + local null tile
    # local start of cell c: the caps of the lower cells of its shard
    by_shard = torch.zeros((R, k), dtype=torch.int64)
    by_shard[owner, torch.arange(k)] = caps_h
    local = (torch.cumsum(by_shard, 1) - by_shard)[owner, torch.arange(k)]
    owner_d, local_d = owner.to(dev), local.to(dev)
    table = owner_d * k + torch.arange(k, device=dev)
    sstarts = torch.zeros((R * k,), dtype=torch.int32, device=dev)
    scaps = torch.zeros((R * k,), dtype=torch.int32, device=dev)
    sstarts[table] = local_d.to(torch.int32)
    scaps[table] = index.caps.to(torch.int32)
    # every list row to its slab row; a row outside every list (none in a
    # packed layout) goes to a trash row past the slabs
    rows = torch.arange(index.capacity_rows, device=dev)
    c = _row_lists(index, rows).clamp(max=k - 1)
    off = rows - index.starts.long()[c]
    inside = (off >= 0) & (off < index.caps.long()[c])
    dst = torch.where(inside, owner_d[c] * rows_loc + local_d[c] + off,
                      R * rows_loc)

    def move(src, fill):
        out = torch.full((R * rows_loc + 1,) + src.shape[1:], fill,
                         dtype=src.dtype, device=dev)
        out[dst] = src[:index.capacity_rows]
        return out[:R * rows_loc]
    return ShardedLists(
        vecs=move(index.vecs, 0), ids=move(index.ids, -1), starts=sstarts,
        caps=scaps, owner=owner, rows_loc=rows_loc, shards=R,
        codes=None if index.codes is None else move(index.codes, 0),
        vnorm=None if index.vnorm is None else move(index.vnorm, 0))


def repack(index: IvfIndex) -> IvfIndex:
    """Rebuild the packed layout with all holes squeezed out."""
    X, ids, assign = _gather_live(index)
    return _with_codec(_pack(X, ids, assign, index.centroids, index.k,
                             index.block_rows, index.repack_threshold),
                       index.codec)


def _with_codec(index: IvfIndex, codec: Optional[_q.Codec]) -> IvfIndex:
    return index if codec is None else attach_codec(index, codec)


def _maybe_repack(index: IvfIndex) -> IvfIndex:
    if index.size < index.repack_threshold * max(index.capacity_rows, 1):
        return repack(index)
    return index


def add(index: IvfIndex, X_new, new_ids=None, *,
        force: Optional[str] = None) -> IvfIndex:
    """Insert vectors (assigned to their nearest centroid through
    ``assign_centroids``), returning a new index.

    The r-th new row of list c (in input order) fills the r-th hole of c in
    row order; a row whose list has no r-th hole overflows, and any overflow
    folds everything into a full repack — the reference's loop
    (``repro/index/ivf.py``, ``add``) as whole-tensor ops.  ``new_ids``
    defaults to ``max(ids) + 1 + arange``.  With a codec, a hole fill
    encodes the rows it wrote and scatters their codes; a repack re-attaches
    the codec.  Syncs the host once (the overflow test), twice more on a
    repack.
    """
    dev = index.device
    X_new = as_f32(X_new, dev)
    m = X_new.shape[0]
    if new_ids is None:
        new_ids = index.ids.max() + 1 + torch.arange(m, device=dev)
    new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
    assign, _ = kops.assign_centroids(X_new, index.centroids, force=force)
    assign = assign.long()

    # rank of each new row among the new rows of its list, in input order
    order = torch.argsort(assign, stable=True)
    counts = torch.bincount(assign, minlength=index.k)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(assign)
    rank[order] = torch.arange(m, device=dev) - first[assign[order]]

    # holes of the lists in row order: hole_at[g] = row of the g-th hole
    cap_rows = index.capacity_rows
    hole = index.ids[:cap_rows] < 0
    H = torch.zeros(cap_rows + 1, dtype=torch.int64, device=dev)
    H[1:] = torch.cumsum(hole.to(torch.int64), 0)
    hole_at = torch.zeros(cap_rows + 1, dtype=torch.int64, device=dev)
    r_all = torch.arange(cap_rows, device=dev)
    hole_at.scatter_(0, torch.where(hole, H[:-1], cap_rows), r_all)
    s = index.starts.long()
    n_holes = H[s + index.caps.long()] - H[s]                  # (k,)
    fits = rank < n_holes[assign]
    # rows that do not fit write (-1, zeros) onto the null tile: a no-op
    g = torch.where(fits, H[s[assign]] + rank, 0)
    target = torch.where(fits, hole_at[g], cap_rows)
    ids = index.ids.clone()
    vecs = index.vecs.clone()
    ids[target] = torch.where(fits, new_ids, -1)
    vecs[target] = torch.where(fits[:, None], X_new, 0.0)
    out = replace(index, ids=ids, vecs=vecs)
    if bool(fits.all()):
        if index.codec is None:
            return out
        # lockstep: encode exactly the rows written, from the same tensor
        c_new, v_new = _q.pack_codes(index.codec, X_new)
        codes = index.codes.clone()
        vnorm = index.vnorm.clone()
        codes[target] = c_new
        vnorm[target] = v_new
        return replace(out, codes=codes, vnorm=vnorm)
    # some list is full: fold the stragglers in via a full repack
    over = torch.nonzero(~fits, as_tuple=True)[0]
    X_all, id_all, a_all = _gather_live(out)
    return _with_codec(_pack(torch.cat([X_all, X_new[over]]),
                             torch.cat([id_all, new_ids[over]]),
                             torch.cat([a_all, assign[over]]),
                             index.centroids, index.k, index.block_rows,
                             index.repack_threshold), index.codec)


def remove(index: IvfIndex, rm_ids) -> IvfIndex:
    """Tombstone the given original ids (codes stay as they are); repack
    when the live fraction of the packed buffer drops below
    ``repack_threshold``."""
    rm = torch.as_tensor(rm_ids).reshape(-1).to(device=index.device,
                                                dtype=torch.int32)
    ids = torch.where(torch.isin(index.ids, rm),
                      torch.full_like(index.ids, -1), index.ids)
    return _maybe_repack(replace(index, ids=ids))
