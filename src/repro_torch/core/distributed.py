"""The sharded topology over a ``torch.distributed`` group.

Counterpart of ``repro.core.distributed``.  Layout, as the reference's:

* X, the KNN graph rows and the assignment are row-sharded: rank r holds
  the contiguous block ``[r·n_loc, (r+1)·n_loc)`` of the rows padded to a
  multiple of the group size R (zero rows, kept out of everything by a
  validity mask, so ``n % R != 0`` runs);
* the composite vectors D are cluster-sharded (rank r owns
  ``[r·k_loc, (r+1)·k_loc)``, k divisible by R) and cnt is replicated;
  scoring materialises the batch's candidate rows through the candidate-row
  exchange (``engine._exchange_rows``).

The public entry points mirror the reference's: every rank passes the full
arrays and gets the full results back; the bodies (``engine.sharded_epoch``
and ``engine.sharded_run``) work on the local blocks.  ``ShardedEngine``
runs ``epoch``, ``run`` and ``distortion``; ``sharded_graph_builder`` is the
group's ``GraphBuilder``.  The group's backend must match the tensors'
device: NCCL with ``cuda``, gloo with ``cpu`` (``ValueError`` otherwise).

Every rank must pass the same arrays and the same randomness (epoch words,
or a generator in the same state): the ranks' visit orders come from them.
On one device ``EngineConfig(shards=R)`` emulates the group: in sparse mode
``ShardedEngine.run`` equals ``engine.run(shards=R)`` bit for bit on the
CPU (the state; the distortions differ in their last bits, as the group
adds per-block partials).

IVF serving shards by cell (``ShardedIvf``): each rank holds one slab of
``index.ivf.shard_lists`` and a round-robin slab of the coarse quantizer,
queries are replicated, and a search is local probe -> gather -> merged
cells -> local raw scan -> gather of the local top-k -> merge -> exact
distances.  Each rank probes its own centroids with ``probe_centroids``,
whose value for a (query, centroid) pair does not depend on the other
centroids, and the merge ranks by value, ties to the lower cell id — the
single-device probe's order; the reference ranks a matmul's raw partials
instead.  The ids equal the single-device ``index.probe.search``'s (with
``rerank=0`` for the codecs; the default rerank can only improve recall,
as each rank reranks its own survivors).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import as_f32
from repro_torch.core import engine
from repro_torch.core.comm import Comm
from repro_torch.core.engine import (BKMState, CandidateSource, EngineConfig,
                                     RunResult, dense_source, graph_source,
                                     probe_source)
from repro_torch.core.graph_build import GraphBuildConfig, GraphBuilder
from repro_torch.index import quantize as _q
from repro_torch.index.ivf import shard_lists
from repro_torch.index.probe import (_no_candidates, _rerank_depth,
                                     build_group_map, build_tile_map,
                                     exact_rerank, merge_probe_cells,
                                     merge_shard_topk)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import finalize_d2
from repro_torch.obs import telemetry as obs_tel

INF = float("inf")


def usable_rows(n: int, shards: int) -> int:
    """Largest row count <= n that ``shards`` divides evenly."""
    return (n // shards) * shards


def _comm(group) -> Comm:
    """``group``: a ProcessGroup, None or "world" for the default group, or
    a ``Comm`` (e.g. a ``core.comm.RecordingComm``), taken as it is."""
    if isinstance(group, Comm):
        return group
    return Comm(None if group in (None, "world") else group)


class ShardedEngine:
    """The clustering engine over a group: ``epoch``, ``run`` and
    ``distortion`` on row-sharded X/G/assign, cluster-sharded D and
    replicated cnt.

    ``kind`` selects the candidate source ('graph' | 'dense' | 'probe'); G
    is the (n, κ) neighbour-id array for 'graph' and ignored otherwise.  k
    must divide by the group size.  ``group`` is a ProcessGroup, or None
    for the default group.
    """

    def __init__(self, group=None, cfg: EngineConfig = EngineConfig(), *,
                 kind: str = "graph", probe_p: int = 8):
        if kind not in ("graph", "dense", "probe"):
            raise ValueError(f"kind must be 'graph', 'dense' or 'probe', got "
                             f"{kind!r}")
        self.comm = _comm(group)
        self.cfg = cfg
        self.kind = kind
        self.probe_p = probe_p
        self.shards = self.comm.size

    def _source(self, G_loc) -> CandidateSource:
        if self.kind == "graph":
            return graph_source(G_loc)
        if self.kind == "probe":
            return probe_source(self.probe_p)
        return dense_source()

    def _rows(self, n: int, dev):
        """(first row, rows, validity mask or None) of this rank's block of
        the rows padded to a multiple of R."""
        R = self.shards
        n_loc = -(-n // R)
        lo = self.comm.rank * n_loc
        rid = torch.arange(lo, lo + n_loc, device=dev)
        return lo, n_loc, (rid < n) if n_loc * R != n else None

    @staticmethod
    def _block(a: torch.Tensor, lo: int, n_loc: int) -> torch.Tensor:
        """Rows [lo, lo + n_loc) of ``a``, zero rows past its end."""
        out = torch.zeros((n_loc,) + a.shape[1:], dtype=a.dtype,
                          device=a.device)
        part = a[lo:lo + n_loc]
        out[:part.shape[0]] = part
        return out

    def _split(self, X, G, assign, D, cnt):
        dev = X.device
        self.comm.check(dev)
        k = D.shape[0]
        if k % self.shards:
            raise ValueError(f"k={k} must divide into {self.shards} cluster "
                             "blocks")
        n = X.shape[0]
        lo, n_loc, valid = self._rows(n, dev)
        k_loc = k // self.shards
        coff = self.comm.rank * k_loc
        X_loc = self._block(X.float(), lo, n_loc)
        G_loc = (self._block(torch.as_tensor(G).to(dev), lo, n_loc)
                 if self.kind == "graph" and G is not None else None)
        st = BKMState(self._block(assign.to(dev, torch.int32), lo, n_loc),
                      D[coff:coff + k_loc].to(dev, torch.float32).clone(),
                      cnt.to(dev, torch.float32).clone(),
                      torch.zeros((), dtype=torch.int32, device=dev))
        src = (None if self.kind == "graph" and G_loc is None
               else self._source(G_loc))
        return X_loc, src, st, coff, valid

    def _full(self, st: BKMState, n: int) -> BKMState:
        return BKMState(self.comm.all_gather(st.assign)[:n],
                        self.comm.all_gather(st.D), st.cnt, st.moves)

    def epoch(self, X, G, assign, D, cnt, words) -> BKMState:
        """One epoch -> BKMState (assign (n,), D (k, d), cnt, moves)."""
        X_loc, src, st, coff, valid = self._split(X, G, assign, D, cnt)
        engine.sharded_epoch(X_loc, st, src, words, self.cfg, self.comm,
                             coff, valid=valid)
        return self._full(st, X.shape[0])

    def run(self, X, G, assign, D, cnt, *, epoch_words=None,
            generator: Optional[torch.Generator] = None) -> RunResult:
        """``cfg.iters`` epochs with the early stop (``engine.sharded_run``:
        one host sync an epoch) -> ``RunResult`` with the full state."""
        X_loc, src, st, coff, valid = self._split(X, G, assign, D, cnt)
        res = engine.sharded_run(X_loc, st, src, self.cfg, self.comm, coff,
                                 epoch_words=epoch_words,
                                 generator=generator, valid=valid)
        return res._replace(state=self._full(res.state, X.shape[0]))

    def distortion(self, X, assign, D, cnt) -> torch.Tensor:
        """() mean distortion over the n rows, recomputed in O(n·d): each
        row's own centroid comes through the candidate-row exchange."""
        X_loc, _, st, coff, valid = self._split(X, None, assign, D, cnt)
        a = st.assign.long()
        rows = engine._exchange_rows(st.assign[:, None], st.D, coff,
                                     self.comm)[:, 0]
        C_own = rows / torch.clamp(st.cnt[a], min=1.0)[:, None]
        vf = (torch.ones_like(st.cnt[a]) if valid is None
              else valid.float())
        diff = (X_loc - C_own) * vf[:, None]
        return self.comm.fsum((diff * diff).sum()) / self.comm.psum(vf.sum())

    def __repr__(self):
        return (f"ShardedEngine(shards={self.shards}, kind={self.kind!r}, "
                f"cfg={self.cfg})")


def make_sharded_epoch(group=None, *, batch_size: int = 1024,
                       eps: float = 0.0, mode: str = "bkm",
                       kind: str = "graph", probe_p: int = 8,
                       sparse_updates: bool = False,
                       payload_bf16: bool = False):
    """The ``epoch`` entry point of a ``ShardedEngine`` (the reference's
    shim)."""
    cfg = EngineConfig(batch_size=batch_size, eps=eps, mode=mode,
                       sparse_updates=sparse_updates,
                       payload_bf16=payload_bf16)
    return ShardedEngine(group, cfg, kind=kind, probe_p=probe_p).epoch


def sharded_distortion(group=None):
    """The ``distortion`` entry point of a ``ShardedEngine``."""
    return ShardedEngine(group).distortion


def sharded_graph_builder(group=None, cfg=None):
    """``core.graph_build.GraphBuilder`` over ``group`` (None: the default
    group): ``builder.build(X, generator=..., draws=...)`` on every rank."""
    return GraphBuilder(cfg or GraphBuildConfig(),
                        group="world" if group is None else group)


class ShardedIvf:
    """IVF serving over a group: the lists sharded by cell.

    Every rank passes the same ``IvfIndex`` (on the device its backend
    serves) and keeps its slab of ``index.ivf.shard_lists`` — the packed
    rows, codes and norms of the cells it owns, its start/cap table and its
    null tile — and its round-robin slab of the coarse quantizer (cells r,
    r + R, ...).  ``search`` is one pass on every rank with no host sync.
    """

    def __init__(self, index, group=None):
        self.comm = _comm(group)
        self.comm.check(index.device)
        R, r = self.comm.size, self.comm.rank
        self.shards = R
        self.k = index.k
        self.d = index.dim
        self.block_rows = index.block_rows
        self.max_list_tiles = index.max_list_tiles
        self.capacity_rows = index.capacity_rows   # scan_frac denominator
        self.codec = index.codec
        parts = shard_lists(index, R)
        rl = parts.rows_loc
        rows, cells = slice(r * rl, (r + 1) * rl), slice(r * self.k,
                                                        (r + 1) * self.k)

        def mine(t, sl):
            return None if t is None else t[sl].clone()
        self.rows_loc = rl
        self.vecs, self.ids = mine(parts.vecs, rows), mine(parts.ids, rows)
        self.codes, self.vnorm = (mine(parts.codes, rows),
                                  mine(parts.vnorm, rows))
        self.starts, self.caps = (mine(parts.starts, cells),
                                  mine(parts.caps, cells))
        del parts
        self.null_tile = rl // self.block_rows - 1
        cid = torch.arange(r, self.k, R, device=index.device)
        self.k_slab = max(-(-self.k // R), 1)
        self.cslab = index.centroids[cid].float().contiguous()
        self.ccid = cid.to(torch.int32)

    def _probe(self, Q, nprobe: int) -> torch.Tensor:
        """The merged (q, nprobe) cells: each rank's top-min(nprobe, its
        cells) by ``probe_centroids``, padded to min(nprobe, k_slab) with
        (+inf, -1), gathered, put in cell-id order, merged by first
        minimum."""
        q = Q.shape[0]
        P = min(nprobe, self.k_slab)
        d_l = torch.full((q, P), INF, device=Q.device)
        i_l = torch.full((q, P), -1, dtype=torch.int32, device=Q.device)
        p_loc = min(nprobe, self.cslab.shape[0])
        if p_loc:
            ids, d2 = kops.probe_centroids(Q, self.cslab, p_loc)
            d_l[:, :p_loc] = d2
            i_l[:, :p_loc] = self.ccid[ids.long()]
        gd = self.comm.all_gather(d_l.T.contiguous())      # (R·P, q)
        gi = self.comm.all_gather(i_l.T.contiguous())
        # ties to the lower cell id, as one probe over all cells ranks them
        o = torch.argsort(gi, dim=0, stable=True)
        return merge_probe_cells(gd.gather(0, o), gi.gather(0, o), nprobe)

    def search(self, Q, *, topk: int = 10, nprobe: int = 8,
               qgroup: Optional[int] = None, telemetry: bool = False,
               codec: str = "f32", rerank: Optional[int] = None):
        """Top-k over the sharded lists -> (ids (q, topk) int32, d2 (q,
        topk) f32), plus a one-row ``Telemetry`` (scanned_rows,
        scanned_rows_max_shard, scan_frac, scanned_bytes) with
        ``telemetry=True``.  Options as ``index.probe.search``'s; every rank
        calls it with the same Q and options and gets the same result."""
        if nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        kind = "f32" if self.codec is None else self.codec.kind
        if codec != "f32":
            if qgroup is not None and qgroup > 1:
                raise ValueError("the codec scan is per-query only (no "
                                 "qgroup)")
            if kind != codec:
                raise ValueError(f"search(codec={codec!r}) on an index "
                                 f"whose payload is {kind!r}")
        dev = self.vecs.device
        Q = as_f32(Q, dev)
        q = Q.shape[0]
        nprobe = min(nprobe, self.k)
        if self.max_list_tiles == 0:       # every list empty
            out = _no_candidates(q, topk, dev)
            return out + (obs_tel.init(1, dev),) if telemetry else out
        cids = self._probe(Q, nprobe)
        bl = self.block_rows
        tm = build_tile_map(cids, self.starts, self.caps,
                            max_tiles=self.max_list_tiles, block_rows=bl,
                            null_tile=self.null_tile)
        if codec != "f32":
            depth = _rerank_depth(topk, rerank)
            lut, qc = _q.build_lut(self.codec, Q)
            lid, lpos, lod = kops.ivf_scan_adc(
                lut, qc, self.vnorm, self.codes, self.ids, tm,
                block_rows=bl, topk=depth or topk)
            if depth:
                # each rank reranks its own survivors against its rows
                lid, lod = exact_rerank(Q, self.vecs, self.ids, lpos,
                                        topk=topk)
        elif qgroup is not None and qgroup > 1:
            # rank-local groups, scattered back to the query order so the
            # gathered lists line up across ranks
            order, union, qmask = build_group_map(tm, group=qgroup,
                                                  null_tile=self.null_tile)
            gi, gd = kops.ivf_scan_grouped(
                Q[order.clamp(max=q - 1).long()], self.vecs, self.ids,
                union, qmask, block_rows=bl, topk=topk, raw=True)
            lid = torch.full((q + 1, topk), -1, dtype=torch.int32, device=dev)
            lod = torch.full((q + 1, topk), INF, device=dev)
            lid[order.long()] = gi
            lod[order.long()] = gd
            lid, lod = lid[:q], lod[:q]
        else:
            lid, lod = kops.ivf_scan(Q, self.vecs, self.ids, tm,
                                     block_rows=bl, topk=topk, raw=True)
        ids, od = merge_shard_topk(self.comm.gather_stacked(lid),
                                   self.comm.gather_stacked(lod), topk)
        out = finalize_d2(ids, od, Q)
        if not telemetry:
            return out
        scanned = self.caps.long()[cids.long()].sum()
        total = self.comm.psum(scanned)
        worst = self.comm.pmax(scanned)
        bpr = 4 * self.d if codec == "f32" else _q.bytes_per_row(
            self.codec, self.d)
        tel = obs_tel.record(
            obs_tel.init(1, dev), 0, scanned_rows=total,
            scanned_rows_max_shard=worst,
            scan_frac=total.float() / (q * max(self.capacity_rows, 1)),
            scanned_bytes=total.float() * bpr)
        return out + (tel,)

    def __repr__(self):
        return (f"ShardedIvf(shards={self.shards}, k={self.k}, "
                f"rows_loc={self.rows_loc})")
