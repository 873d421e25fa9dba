"""Clustering engine: candidate -> score -> move, on one device or a group.

Counterpart of ``repro.core.engine``.  Per mini-batch: the candidate
clusters are those of the samples' κ graph neighbours (looked up in the
epoch-start assignment), ``gather_score`` scores them (ΔI of paper Eqn. 3,
or the lloyd distance), the best move is accepted, a leaver guard keeps
every cluster non-empty, and the running statistics (D, cnt) take the
moves as two ``index_add_`` scatters.

Candidate sources: ``graph`` (the clusters of the sample's κ neighbours),
``dense`` (all k clusters, scored with one ``(B, k)`` matmul, as the
reference's ``_score_dense`` computes them outside any kernel; PQ training
runs it in lloyd mode) and ``probe`` (the p clusters whose centroids
``D / max(cnt, 1)`` lie nearest the sample, from ``probe_centroids``, plus
the sample's own cluster as the last column, so empty cells cannot crowd
it out).  The probe kernel's cap p <= 128 is a stated difference:
``probe_source`` raises above it.

Topologies.  ``epoch`` and ``run`` are the single-device pass; with
``EngineConfig(shards=R)`` they emulate an R-way sharded run on one device:
the blocked visit order (one shared local Feistel permutation of ``n // R``
rows, shard s owning rows ``[s·n_loc, (s+1)·n_loc)``), per-shard scoring at
the shards' own shapes (the graph source from materialised rows
``D[cand]``, ``_score_from_rows``; the dense source per cluster block,
``_score_dense_emulated``), and, without ``sparse_updates``, per-shard
partial deltas summed in shard order.  ``sharded_epoch`` and
``sharded_run`` are the same steps over a ``torch.distributed`` group
(``core.comm.Comm``; ``core.distributed.ShardedEngine`` wraps them): rows,
graph rows and the assignment are row-sharded, D is cluster-sharded (rank r
owns rows ``[r·k_loc, (r+1)·k_loc)``, ``coff = r·k_loc``) and cnt is
replicated.  Scoring materialises the batch's candidate rows through the
candidate-row exchange (``_exchange_rows``: an all-gather of ids and a SUM
all-reduce of owner-masked rows, exact in any order); updates either gather
every rank's moves and scatter the owned rows (``sparse_updates``, with the
payload in bf16 under ``payload_bf16``) or sum the per-rank deltas in rank
order (``Comm.fsum_owned``: each rank receives its own cluster block of
every rank's deltas).  In sparse mode a group run equals its emulation bit
for bit on the CPU; in dense mode too, as both add the same per-shard
deltas in the same order.  ``valid`` masks (padded rows) keep rows out of
moves, statistics and the distortion in both topologies.

Differences from the reference, all stated:

* State is updated in place (``BKMState`` tensors are mutated by ``epoch``
  and ``run``); the reference's arrays are immutable and donated.
* The D/cnt scatter is atomic on CUDA, so D depends on the order of the
  adds in its last ulp; the counts and the leaver guard's counts are
  integer-valued and exact.  Scores therefore match the reference to float32
  rounding, and a run can diverge from it once one borderline move flips.
* Host syncs: ``run`` and ``sharded_run`` read each epoch's move count
  (with its distortion) once, for the ``min_move_frac`` early stop — ONE
  host sync per epoch — where the reference's in-trace ``while_loop``
  syncs once per run.  The read goes through ``obs.syncs.read``, so an
  active ``sync_counter`` counts it.  An epoch itself syncs nothing: the
  visit order is made on the CPU and copied without blocking
  (``core.permute``).
* The group's cluster offset is ``coff = rank · k_loc``.  The reference
  derives it from data (the first element of a sharded ``arange(k)``) only
  to dodge an XLA:CPU partitioning hazard that torch does not have.
* The reference moves the batch rows as a transposed (d, R·B) gather and
  the dense deltas as one (d, k) psum to keep its replication audit quiet;
  here the rows travel as (R·B, d), and each rank's (k, d) deltas go out
  by one all-to-all of its R cluster blocks (``Comm.fsum_owned``): a rank
  receives the R blocks of its own k_loc rows and adds them in rank order
  (the reference's psum leaves the order to the backend), which is what
  makes dense group runs equal their emulation.  A rank moves
  k·d·4·(R−1)/R bytes for them, the psum's ring moves twice that.  The
  counts' (k,) deltas are integer-valued and take a psum.
* The bf16 payload travels as bf16: gloo has no 16-bit integer
  collectives, and eager torch does not hoist the f32 conversion across
  the gather, which is why the reference bitcasts it to u16.
* Telemetry (``EngineConfig(telemetry=True)``): ``run`` fills one row per
  epoch on the device (``RunResult.telemetry``) and adds no host sync; the
  rows stay on the device.  With it off, the move step launches nothing
  more than it does without the option.

``run_slices`` is the dense source over P independent slices at once (the
reference vmaps ``run_inline`` over cache slices in ``core.kv_cluster``):
each move step scores every slice with one ``bmm``, and the leaver guard and
the two scatters use flat ``slice·k + cluster`` ids, so an epoch launches
what one slice's epoch launches.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import permute
from repro_torch.core.comm import Comm, ordered_sum
from repro_torch.core.objective import cluster_stats
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.centroid_assign import MAX_P
from repro_torch.obs import syncs
from repro_torch.obs import telemetry as obs_tel

INF = float("inf")


class BKMState(NamedTuple):
    assign: torch.Tensor  # (n,) int32
    D: torch.Tensor       # (k, d) float32 composite vectors
    cnt: torch.Tensor     # (k,) float32
    moves: torch.Tensor   # () int32 — moves accepted in the last epoch


class CandidateSource(NamedTuple):
    """Which clusters each sample may move to: kind='graph' (the clusters
    of the (n, κ) neighbour ids ``G``), kind='dense' (all k clusters) or
    kind='probe' (the ``p`` nearest centroids and the sample's own)."""

    kind: str
    G: Optional[torch.Tensor] = None   # (n, κ) neighbour ids, int64
    p: int = 0                         # probe width


class EngineConfig(NamedTuple):
    batch_size: int = 1024
    mode: str = "bkm"           # 'bkm' (Eqn. 3) | 'lloyd' (§5.2 variant)
    eps: float = 0.0            # minimum ΔI gain to accept a move
    iters: int = 1              # epochs for `run`
    min_move_frac: float = 0.0  # `run` stops when epoch moves <= frac * n
    sparse_updates: bool = False  # group: gather moved rows, not deltas
    payload_bf16: bool = False    # sparse payload in bf16
    shards: int = 1             # one device: emulate an R-way sharded order
    force: Optional[str] = None  # kernel dispatch override (None | 'ref')
    telemetry: bool = False     # `run`: per-epoch Telemetry rows


def init_state(X: torch.Tensor, assign: torch.Tensor, k: int) -> BKMState:
    stats = cluster_stats(X, assign, k)
    return BKMState(assign.to(torch.int32).clone(), stats.D, stats.cnt,
                    torch.zeros((), dtype=torch.int32, device=X.device))


def graph_source(G: torch.Tensor) -> CandidateSource:
    """Candidates = clusters of the graph neighbours (-1 ids clamp to 0)."""
    return CandidateSource("graph", torch.clamp(G, min=0).long())


def dense_source() -> CandidateSource:
    """Candidates = all k clusters, scored with one matmul per batch."""
    return CandidateSource("dense")


def probe_source(p: int) -> CandidateSource:
    """Candidates = the p nearest centroids ``D / max(cnt, 1)`` of each
    sample (``probe_centroids``) plus its own cluster; 1 <= p <= 128."""
    if not 1 <= p <= MAX_P:
        raise ValueError(f"probe source: need 1 <= p <= {MAX_P} (the probe "
                         f"kernel's cap), got p={p}")
    return CandidateSource("probe", p=p)


def _check_cfg(cfg: EngineConfig, source: CandidateSource) -> None:
    if source.kind not in ("graph", "dense", "probe"):
        raise NotImplementedError(f"{source.kind} source: not ported yet")
    if cfg.mode not in ("bkm", "lloyd"):
        raise ValueError(f"mode must be 'bkm' or 'lloyd', got {cfg.mode!r}")
    if cfg.shards < 1:
        raise ValueError(f"shards must be >= 1, got {cfg.shards}")


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _score_gathered(xb, u, cand, D, cnt, mode, eps, force):
    """Best move per sample among gathered candidates -> (moved, want_v)."""
    is_self = cand == u[:, None]
    if mode == "bkm":
        score = kops.gather_score(xb, u, cand, D, cnt, mode="bkm",
                                  force=force)
        score = torch.where(is_self, -INF, score)
        best = score.argmax(dim=1)
        moved = score.gather(1, best[:, None])[:, 0] > eps
    else:
        d2 = kops.gather_score(xb, u, cand, D, cnt, mode="lloyd",
                               force=force)
        best = d2.argmin(dim=1)
        moved = ~is_self.gather(1, best[:, None])[:, 0]
    want_v = cand.gather(1, best[:, None])[:, 0]
    return moved, want_v


def _score_from_rows(xb, u, cand, rows, cnt, mode, eps):
    """Best move per sample from materialised candidate rows
    (``repro/core/engine.py::_score_from_rows``, same op order).

    ``cand`` (B, C) candidate ids whose LAST column is the sample's own
    cluster u; ``rows`` the matching (B, C, d) composite vectors — from the
    candidate-row exchange in a group, from ``D[cand]`` in the emulation:
    the same values, so both topologies share every flop after it."""
    dots = torch.einsum("bd,bcd->bc", xb, rows)          # (B, C)
    dsq = (rows * rows).sum(-1)                          # (B, C)
    xsq = (xb * xb).sum(-1)                              # (B,)
    nv = cnt[cand.long()]                                # (B, C)
    is_self = cand == u[:, None]
    if mode == "bkm":
        gain_v = ((dsq + 2.0 * dots + xsq[:, None]) / (nv + 1.0)
                  - torch.where(nv > 0, dsq / torch.clamp(nv, min=1.0),
                                0.0))
        du_sq = dsq[:, -1]
        x_du = dots[:, -1]
        nu = cnt[u.long()]
        num_u = du_sq - 2.0 * x_du + xsq
        resid = torch.where(nu > 1, num_u / torch.clamp(nu - 1.0, min=1.0),
                            0.0)
        score = gain_v + (resid - du_sq / torch.clamp(nu, min=1.0))[:, None]
        score = torch.where(is_self, -INF, score)
        best = score.argmax(dim=1)
        moved = score.gather(1, best[:, None])[:, 0] > eps
    else:
        csq_n = torch.clamp(nv, min=1.0)
        d2 = dsq / (csq_n * csq_n) - 2.0 * dots / csq_n
        d2 = torch.where(nv > 0, d2, INF)
        best = d2.argmin(dim=1)
        moved = ~is_self.gather(1, best[:, None])[:, 0]
    want_v = cand.gather(1, best[:, None])[:, 0]
    return moved, want_v


def _score_dense(xb, u, D, cnt, mode, eps):
    """Best move per sample over all k clusters, from one (B, k) matmul
    (``repro/core/engine.py::_score_dense``, same op order).  With a
    leading slice axis — xb (P, B, d), u (P, B), D (P, k, d), cnt (P, k) —
    the product is one ``bmm`` and every slice is scored the same way."""
    k = D.shape[-2]
    ul = u.long()
    dsq = (D * D).sum(-1)                                 # (..., k)
    dots = xb @ D.mT                                      # (..., B, k)
    xsq = (xb * xb).sum(-1)                               # (..., B)
    if mode == "bkm":
        nv = cnt[..., None, :]
        gain_v = ((dsq[..., None, :] + 2.0 * dots + xsq[..., None])
                  / (nv + 1.0)
                  - torch.where(nv > 0, dsq[..., None, :] / torch.clamp(
                      nv, min=1.0), 0.0))
        du_sq = dsq.gather(-1, ul)
        x_du = dots.gather(-1, ul[..., None])[..., 0]
        nu = cnt.gather(-1, ul)
        num_u = du_sq - 2.0 * x_du + xsq
        resid = torch.where(nu > 1, num_u / torch.clamp(nu - 1.0, min=1.0),
                            0.0)
        score = gain_v + (resid - du_sq / torch.clamp(nu, min=1.0))[..., None]
        cols = torch.arange(k, device=xb.device)
        score = torch.where(cols == ul[..., None], -INF, score)
        best = score.argmax(dim=-1)                       # first maximum
        moved = score.gather(-1, best[..., None])[..., 0] > eps
    else:
        csq_n = torch.clamp(cnt, min=1.0)
        d2 = (dsq[..., None, :] / (csq_n * csq_n)[..., None, :]
              - 2.0 * dots / csq_n[..., None, :])
        d2 = torch.where(cnt[..., None, :] > 0, d2, INF)
        best = d2.argmin(dim=-1)                          # first minimum
        moved = best != ul
    return moved, best.to(torch.int32)


def _dense_block_scores(xa, ua, D_blk, cnt, coff_blk: int, mode):
    """One cluster block's best (value, global id) per row: shared by the
    group (each rank scores the gathered rows against its block) and the
    emulation (a loop over the R blocks), so the merged first-max/min sees
    the same operands in both."""
    k_loc = D_blk.shape[0]
    ids_loc = coff_blk + torch.arange(k_loc, device=xa.device)
    dsq = (D_blk * D_blk).sum(-1)                        # (k_loc,)
    dots = xa @ D_blk.T                                  # (R·B, k_loc)
    xsq = (xa * xa).sum(-1)
    nv = cnt[ids_loc][None, :]
    if mode == "bkm":
        gain_v = ((dsq[None, :] + 2.0 * dots + xsq[:, None]) / (nv + 1.0)
                  - torch.where(nv > 0, dsq[None, :] / torch.clamp(
                      nv, min=1.0), 0.0))
        part = torch.where(ids_loc[None, :] == ua.long()[:, None], -INF,
                           gain_v)
        bi = part.argmax(dim=1)
    else:
        csq_n = torch.clamp(nv, min=1.0)
        d2 = dsq[None, :] / (csq_n * csq_n) - 2.0 * dots / csq_n
        part = torch.where(nv > 0, d2, INF)
        bi = part.argmin(dim=1)
    bv = part.gather(1, bi[:, None])[:, 0]
    return bv, ids_loc[bi].to(torch.int32)


def _dense_moved_bkm(xb, u, Du, cnt, gain, eps):
    """bkm acceptance from the merged best gain and the row's own-cluster
    terms (constant per row: only this eps test needs them)."""
    du_sq = (Du * Du).sum(-1)
    x_du = (xb * Du).sum(-1)
    xsq = (xb * xb).sum(-1)
    nu = cnt[u.long()]
    num_u = du_sq - 2.0 * x_du + xsq
    resid = torch.where(nu > 1, num_u / torch.clamp(nu - 1.0, min=1.0), 0.0)
    return (gain + resid - du_sq / torch.clamp(nu, min=1.0)) > eps


def _merge_blocks(gbv, gbi, mode):
    """First max (bkm) or min (lloyd) over the stacked block bests (R, ·):
    blocks are ascending contiguous cluster ranges, so this keeps the
    single-pass lowest-index tie-break.  Returns (best id, its value)."""
    pick = (gbv.argmax(dim=0) if mode == "bkm" else gbv.argmin(dim=0))
    return (gbi.gather(0, pick[None])[0],
            gbv.gather(0, pick[None])[0])


def _score_dense_emulated(xb, u, D, cnt, mode, eps, R):
    """One-device mirror of ``_score_dense_sharded`` over the whole
    concatenated batch: the same per-block shapes and stacked merge; the
    owned-row exchange collapses to ``D[u]``."""
    k_loc = cnt.shape[0] // R
    outs = [_dense_block_scores(xb, u, D[t * k_loc:(t + 1) * k_loc], cnt,
                                t * k_loc, mode) for t in range(R)]
    best, gain = _merge_blocks(torch.stack([o[0] for o in outs]),
                               torch.stack([o[1] for o in outs]), mode)
    if mode == "bkm":
        return _dense_moved_bkm(xb, u, D[u.long()], cnt, gain, eps), best
    return best != u, best


def _score_local(xb, u, idx, lookup, D, cnt, source, cfg, cbuf):
    """Scoring with the full (k, d) D on one device (the emulation's
    graph source from materialised rows, as the group scores it)."""
    if source.kind == "dense":
        return _score_dense(xb, u, D, cnt, cfg.mode, cfg.eps)
    if source.kind == "probe":
        ids, _ = kops.probe_centroids(xb, cbuf, source.p, force=cfg.force)
        # the sample's own cluster stays a candidate:
        # empty cells, centroids at the origin, can crowd it out
        cand = torch.cat([ids.to(torch.int32), u[:, None]], dim=1)
    else:
        cand = lookup[source.G[idx]]                      # (B, κ) int32
        if cfg.shards > 1:
            cand_u = torch.cat([cand, u[:, None]], dim=1)
            return _score_from_rows(xb, u, cand_u, D[cand_u.long()], cnt,
                                    cfg.mode, cfg.eps)
    return _score_gathered(xb, u, cand, D, cnt, cfg.mode, cfg.eps, cfg.force)


# ---------------------------------------------------------------------------
# the group's scoring: D cluster-sharded, D_loc = D[coff:coff + k_loc]
# ---------------------------------------------------------------------------

def _exchange_rows(ids, D_loc, coff: int, comm: Comm):
    """``D[ids]`` against a cluster-sharded D: every rank gathers all
    ranks' (B, C) ids, contributes the rows it owns (zeros elsewhere), and a
    SUM all-reduce completes them — each element is one owner's value plus
    zeros, exact in any order.  Returns this rank's (B, C, d) rows."""
    B = ids.shape[0]
    k_loc = D_loc.shape[0]
    loc = comm.all_gather(ids, label="exchange").long() - coff  # (R·B, C)
    own = (loc >= 0) & (loc < k_loc)
    rows = torch.where(own[..., None], D_loc[loc.clamp(0, k_loc - 1)], 0.0)
    rows = comm.psum(rows, label="exchange")
    return rows[comm.rank * B:(comm.rank + 1) * B]


def _probe_sharded(xb, D_loc, cnt, coff: int, p: int, comm: Comm):
    """Top-p probe against cluster-sharded centroids: the batch rows travel,
    each rank ranks all of them against its own cells on the raw partials
    (a matmul and a stable top-min(p, k_loc)), and the per-rank lists are
    merged by first minimum in rank order (``kernels.ref.first_min_merge``)
    — the union holds the global top-p."""
    k = cnt.shape[0]
    B = xb.shape[0]
    k_loc = D_loc.shape[0]
    xa = comm.all_gather(xb)                             # (R·B, d)
    C_loc = D_loc / torch.clamp(cnt[coff:coff + k_loc], min=1.0)[:, None]
    csq = (C_loc * C_loc).sum(-1)
    part = csq[None, :] - 2.0 * (xa @ C_loc.T)           # (R·B, k_loc)
    ids0 = (coff + torch.arange(k_loc, device=xb.device)).expand(part.shape)
    d_l, i_l = kref.stable_topk(part, ids0, min(p, k_loc))
    gd = comm.all_gather(d_l.T.contiguous())             # (R·p_loc, R·B)
    gi = comm.all_gather(i_l.T.contiguous())
    sel = kref.first_min_merge(gd, gi, min(p, k))        # (R·B, min(p, k))
    return sel[comm.rank * B:(comm.rank + 1) * B]


def _score_dense_sharded(xb, u, D_loc, cnt, mode, eps, coff: int,
                         comm: Comm):
    """Dense scoring with cluster-sharded centroids: the batch rows travel,
    every rank scores all gathered rows against its block, and only the
    per-block bests are exchanged."""
    B = xb.shape[0]
    s = comm.rank
    bv, bid = _dense_block_scores(comm.all_gather(xb), comm.all_gather(u),
                                  D_loc, cnt, coff, mode)
    best, gain = _merge_blocks(comm.gather_stacked(bv),
                               comm.gather_stacked(bid), mode)
    best = best[s * B:(s + 1) * B]
    if mode == "bkm":
        Du = _exchange_rows(u[:, None], D_loc, coff, comm)[:, 0]
        return (_dense_moved_bkm(xb, u, Du, cnt, gain[s * B:(s + 1) * B],
                                 eps), best)
    return best != u, best


def _score_sharded(xb, u, idx, lookup, D_loc, cnt, source, cfg, comm, coff):
    """Scoring in a group: sharded D, candidate-row exchange."""
    if source.kind == "dense":
        return _score_dense_sharded(xb, u, D_loc, cnt, cfg.mode, cfg.eps,
                                    coff, comm)
    if source.kind == "graph":
        cand = lookup[source.G[idx]]
    else:
        cand = _probe_sharded(xb, D_loc, cnt, coff, source.p, comm)
    cand_u = torch.cat([cand.to(torch.int32), u[:, None]], dim=1)
    rows = _exchange_rows(cand_u, D_loc, coff, comm)
    return _score_from_rows(xb, u, cand_u, rows, cnt, cfg.mode, cfg.eps)


# ---------------------------------------------------------------------------
# the shared move step
# ---------------------------------------------------------------------------

def _deltas(u, v, gx, w, k):
    """(k, d) and (k,) deltas of the moves u -> v: two ``index_add_``."""
    both = torch.cat([u.long(), v.long()])
    dD = torch.zeros((k, gx.shape[1]), dtype=gx.dtype, device=gx.device)
    dD.index_add_(0, both, torch.cat([-gx, gx]))
    dc = torch.zeros((k,), dtype=w.dtype, device=w.device)
    dc.index_add_(0, both, torch.cat([-w, w]))
    return dD, dc


def _sparse_update(st, xb, u, moved, want_v, k, cfg, comm, coff):
    """The group's sparse update: gather every rank's proposals, apply the
    leaver guard and scatter the owned rows — the same adds in the same
    gathered-row order as the emulation's scatter over the full D."""
    gx = xb * moved.float()[:, None]
    if cfg.payload_bf16:
        gx = gx.to(torch.bfloat16)
    gu = comm.all_gather(u, label="sparse_sync")
    gv = comm.all_gather(torch.where(moved, want_v, u), label="sparse_sync")
    gx = comm.all_gather(gx, label="sparse_sync").float()
    gul = gu.long()
    leav = torch.zeros((k,), dtype=torch.float32, device=xb.device)
    leav.index_add_(0, gul, (gu != gv).float())
    ok = (st.cnt - leav) >= 1.0
    gv = torch.where(ok[gul], gv, gu)                    # veto unsafe moves
    keep = (gu != gv).float()
    gx = gx * keep[:, None]
    # scatter only the owned rows into this rank's block: the others add
    # -0.0 to a clamped row, the exact identity of float addition
    k_loc = st.D.shape[0]
    iu, iv = gul - coff, gv.long() - coff
    own_u = (iu >= 0) & (iu < k_loc)
    own_v = (iv >= 0) & (iv < k_loc)
    st.D.index_add_(0, torch.cat([iu.clamp(0, k_loc - 1),
                                  iv.clamp(0, k_loc - 1)]),
                    torch.cat([torch.where(own_u[:, None], -gx, -0.0),
                               torch.where(own_v[:, None], gx, -0.0)]))
    both = torch.cat([gul, gv.long()])
    st.cnt.index_add_(0, both, torch.cat([-keep, keep]))
    return moved & ok[u.long()]


def _move_step(X, st: BKMState, idx, lookup, source, cfg: EngineConfig,
               cbuf=None, proposed=None, valid=None, comm=None, coff=0):
    """One batched candidate -> score -> move step, in place on ``st``.

    ``idx`` indexes rows of the local X/assign; ``lookup`` is the global
    epoch-start assignment.  ``comm`` (a ``Comm``) runs the group's step
    with ``st.D`` this rank's (k_loc, d) block from global row ``coff``;
    None runs the one-device step (``cfg.shards`` > 1 emulates R shards).
    ``cbuf`` (k, d): the one-device probe source's centroid buffer, refilled
    here with ``D / max(cnt, 1)``.  ``proposed`` (() int32, or None): adds
    the batch's moves before the leaver guard.  ``valid`` (n,) bool or
    None: rows that may move."""
    k = st.cnt.shape[0]
    R = 1 if comm is not None else cfg.shards
    xb = X[idx]
    u = st.assign[idx]
    if comm is not None:
        moved, want_v = _score_sharded(xb, u, idx, lookup, st.D, st.cnt,
                                       source, cfg, comm, coff)
    elif R > 1 and source.kind == "dense":
        # the group gathers all R shards' rows and merges per block, so the
        # emulation scores the whole concatenated batch in those shapes
        moved, want_v = _score_dense_emulated(xb, u, st.D, st.cnt, cfg.mode,
                                              cfg.eps, R)
    else:
        if source.kind == "probe":
            torch.div(st.D, torch.clamp(st.cnt, min=1.0)[:, None], out=cbuf)
        # per emulated shard, at the group's (bs, C) shapes
        bs = idx.shape[0] // R
        parts = [_score_local(xb[s * bs:(s + 1) * bs], u[s * bs:(s + 1) * bs],
                              idx[s * bs:(s + 1) * bs], lookup, st.D, st.cnt,
                              source, cfg, cbuf) for s in range(R)]
        moved = torch.cat([p[0] for p in parts]) if R > 1 else parts[0][0]
        want_v = torch.cat([p[1] for p in parts]) if R > 1 else parts[0][1]
    if valid is not None:
        moved = moved & valid[idx]
    if proposed is not None:
        proposed.add_(moved.sum(dtype=torch.int32))
    ul = u.long()
    if comm is not None and cfg.sparse_updates:
        moved = _sparse_update(st, xb, u, moved, want_v, k, cfg, comm, coff)
        v = torch.where(moved, want_v, u)
    else:
        # leaver guard: block all leavers of a cluster whose leaver count
        # would reach its population (conservative, rare)
        leav = torch.zeros((k,), dtype=torch.float32, device=X.device)
        leav.index_add_(0, ul, moved.float())
        if comm is not None:
            leav = comm.psum(leav)
        moved = moved & ((st.cnt - leav) >= 1.0)[ul]
        v = torch.where(moved, want_v, u)
        w = moved.float()
        gx = xb * w[:, None]
        if comm is not None:
            # dense sync: each rank receives every rank's deltas of its own
            # cluster block and adds them in rank order; the counts are
            # integer-valued, exact in any order
            dD, dc = _deltas(u, v, gx, w, k)
            st.D.add_(comm.fsum_owned(dD, st.D.shape[0], label="dense_sync"))
            st.cnt.add_(comm.psum(dc, label="dense_sync"))
        elif R > 1 and not cfg.sparse_updates:
            # mirror the group's dense sync: per-shard partial deltas,
            # summed in shard order
            bs = idx.shape[0] // R
            parts = [_deltas(u[s * bs:(s + 1) * bs], v[s * bs:(s + 1) * bs],
                             gx[s * bs:(s + 1) * bs], w[s * bs:(s + 1) * bs],
                             k) for s in range(R)]
            st.D.add_(ordered_sum([p[0] for p in parts]))
            st.cnt.add_(ordered_sum([p[1] for p in parts]))
        else:
            if cfg.payload_bf16 and cfg.sparse_updates:
                gx = gx.to(torch.bfloat16).float()
            both = torch.cat([ul, v.long()])
            st.D.index_add_(0, both, torch.cat([-gx, gx]))
            st.cnt.index_add_(0, both, torch.cat([-w, w]))
    st.assign[idx] = v
    st.moves.add_(moved.sum(dtype=torch.int32))


# ---------------------------------------------------------------------------
# epochs and runs, both topologies
# ---------------------------------------------------------------------------

def _epoch(X, state, source, words, cfg, proposed, valid, comm, coff):
    n = X.shape[0]
    R = 1 if comm is not None else cfg.shards
    if comm is None and R > 1 and source.kind == "dense" and \
            state.cnt.shape[0] % R:
        raise ValueError(f"dense source with shards={R}: k="
                         f"{state.cnt.shape[0]} must divide into {R} blocks")
    n_loc = n // R
    bs = min(cfg.batch_size, n_loc)
    nb = max(n_loc // bs, 1)
    # the visit order: one shared local permutation; emulated shard s owns
    # the rows [s·n_loc, (s+1)·n_loc)
    order = permute.epoch_order(words, n_loc, X.device)
    if R > 1:
        order = order[None, :] + (torch.arange(R, device=X.device)
                                  * n_loc)[:, None]
    # candidate lookup: the global epoch-start assignment
    lookup = (state.assign.clone() if comm is None
              else comm.all_gather(state.assign))
    cbuf = (torch.empty_like(state.D)
            if source.kind == "probe" and comm is None else None)
    state.moves.zero_()
    if proposed is not None:
        proposed.zero_()
    for i in range(nb):
        _move_step(X, state, order[..., i * bs:(i + 1) * bs].reshape(-1),
                   lookup, source, cfg, cbuf, proposed, valid, comm, coff)
    if comm is not None:
        state.moves.copy_(comm.psum(state.moves))
        if proposed is not None:
            proposed.copy_(comm.psum(proposed))
    return state


def epoch(X: torch.Tensor, state: BKMState, source: CandidateSource,
          words: permute.Words, cfg: EngineConfig = EngineConfig(),
          proposed: Optional[torch.Tensor] = None,
          valid: Optional[torch.Tensor] = None) -> BKMState:
    """One pass over a shuffled view of the data in mini-batches.

    Visits ``R · (n_loc // bs) · bs`` samples (``R = cfg.shards``,
    ``n_loc = n // R``) in the Feistel order of ``words`` (the epoch's 4
    subkey words).  Candidates come from the epoch-start assignment.
    Updates ``state`` in place and returns it with ``moves`` set to this
    epoch's accepted moves.  No host sync.

    ``proposed``: a side tensor (() int32 on X's device) that receives the
    epoch's moves proposed before the leaver guard (zeroed first) — how
    ``run`` fills its telemetry; the reference's ``_epoch_impl`` returns
    that count beside the state.  None (the default) counts nothing, with
    ``cfg.telemetry`` on or off.  ``valid`` (n,) bool: rows that may move
    (padded rows are False).
    """
    _check_cfg(cfg, source)
    return _epoch(X, state, source, words, cfg, proposed, valid, None, 0)


def sharded_epoch(X_loc: torch.Tensor, state: BKMState,
                  source: CandidateSource, words: permute.Words,
                  cfg: EngineConfig, comm: Comm, coff: int,
                  proposed: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None) -> BKMState:
    """One epoch over a group (the reference's ``sharded_epoch_body``).

    ``X_loc`` / ``state.assign`` / ``source.G`` / ``valid`` are this
    rank's rows, ``state.D`` its (k_loc, d) cluster block from global row
    ``coff`` and ``state.cnt`` the replicated (k,).  Every rank visits its
    rows in the one shared local order of ``words``.  ``state.moves`` and
    ``proposed`` come back summed over the group.  No host sync."""
    _check_cfg(cfg, source)
    comm.check(X_loc.device)
    return _epoch(X_loc, state, source, words, cfg, proposed, valid, comm,
                  coff)


def stats_distortion(xsq_total, D, cnt, n) -> torch.Tensor:
    """Distortion in O(k·d) from the running statistics (paper Eqn. 2/4)."""
    dsq = (D * D).sum(-1)
    obj = torch.where(cnt > 0, dsq / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(dsq)).sum()
    return (xsq_total - obj) / n


def _stats_distortion_sharded(xsq_total, D_loc, cnt, n, coff, comm):
    """``stats_distortion`` with cluster-sharded D: the per-block partial
    objectives, added in rank order."""
    cnt_loc = cnt[coff:coff + D_loc.shape[0]]
    dsq = (D_loc * D_loc).sum(-1)
    obj = torch.where(cnt_loc > 0, dsq / torch.clamp(cnt_loc, min=1.0),
                      torch.zeros_like(dsq)).sum()
    return (xsq_total - comm.fsum(obj)) / n


class RunResult(NamedTuple):
    state: BKMState
    history: List[float]    # per-epoch distortion, epochs run
    moves: List[int]        # per-epoch accepted moves
    epochs: int
    final: torch.Tensor     # () f32 distortion after the last epoch
    host_syncs: int         # host syncs this run performed
    # per-epoch Telemetry on X's device (cfg.telemetry; else None): moves,
    # proposed, empty_clusters, distortion, hit_rate; rows past the epochs
    # run stay 0
    telemetry: Optional[obs_tel.Telemetry] = None


def _run(X, state, source, cfg, epoch_words, generator, valid, comm, coff):
    if epoch_words is None and generator is None:
        raise ValueError("pass epoch_words or a generator")
    dev = X.device
    Xf = X.float() if valid is None else X.float() * valid.float()[:, None]
    n_host = None
    if comm is None:
        xsq_total = (Xf ** 2).sum()
        if valid is None:
            n = n_host = X.shape[0]
        else:
            n = valid.float().sum()
    else:
        xsq_total = comm.fsum((Xf ** 2).sum())
        n = comm.psum(valid.float().sum() if valid is not None else
                      torch.full((), float(X.shape[0]), device=dev))

    def dist_of(st):
        if comm is None:
            return stats_distortion(xsq_total, st.D, st.cnt, n)
        return _stats_distortion_sharded(xsq_total, st.D, st.cnt, n, coff,
                                         comm)
    hist, mhist = [], []
    reads = 0
    tel = obs_tel.init(cfg.iters, dev) if cfg.telemetry else None
    prop = (torch.zeros((), dtype=torch.int32, device=dev)
            if cfg.telemetry else None)
    for t in range(cfg.iters):
        words = (epoch_words[t] if epoch_words is not None
                 else permute.draw_words(generator))
        _epoch(X, state, source, words, cfg, prop, valid, comm, coff)
        dist = dist_of(state)
        if tel is not None:
            obs_tel.record(
                tel, t, moves=state.moves, proposed=prop,
                empty_clusters=(state.cnt <= 0.0).sum(dtype=torch.int32),
                distortion=dist,
                hit_rate=state.moves.float() / torch.clamp(prop.float(),
                                                           min=1.0))
        # one transfer: the move count and the f32 values bit-cast to int32
        vals = [state.moves, dist.view(torch.int32)]
        if n_host is None:
            vals.append(n.view(torch.int32))
        got = syncs.read(torch.stack(vals))
        f32 = got[1:].view(torch.float32).tolist()
        reads += 1
        hist.append(f32[0])
        mhist.append(int(got[0]))
        if mhist[-1] <= cfg.min_move_frac * (n_host if n_host is not None
                                             else f32[1]):
            break
    return RunResult(state, hist, mhist, len(hist), dist_of(state), reads,
                     tel)


def run(X: torch.Tensor, state: BKMState, source: CandidateSource,
        cfg: EngineConfig, *, epoch_words: Optional[Sequence] = None,
        generator: Optional[torch.Generator] = None,
        valid: Optional[torch.Tensor] = None) -> RunResult:
    """Multi-epoch run with the ``min_move_frac`` early stop.

    ``epoch_words`` (iters, 4) gives each epoch's subkey words (the
    reference's ``jax.random.bits(fold_in(key, t), (4,))``); otherwise they
    are drawn from ``generator`` (a CPU ``torch.Generator``).  ``valid``
    (n,) bool keeps padded rows out of moves and of the distortion (n
    counts the valid rows).  Host syncs: exactly one per epoch run (its move
    count and distortion are read together for the early stop, through
    ``obs.syncs.read``); the final distortion stays on device, and so does
    the telemetry.
    """
    _check_cfg(cfg, source)
    return _run(X, state, source, cfg, epoch_words, generator, valid, None,
                0)


def sharded_run(X_loc: torch.Tensor, state: BKMState, source: CandidateSource,
                cfg: EngineConfig, comm: Comm, coff: int, *,
                epoch_words: Optional[Sequence] = None,
                generator: Optional[torch.Generator] = None,
                valid: Optional[torch.Tensor] = None) -> RunResult:
    """``run`` over a group (the reference's ``sharded_run_body``): the
    local blocks of ``sharded_epoch``, the distortion from the per-block
    objectives (``Σ||x||²`` and the valid count summed over the group once),
    one host sync per epoch on every rank (the values read are the group's,
    equal on all ranks), telemetry rows replicated.  Every rank must pass
    the same ``epoch_words``, or a generator in the same state."""
    _check_cfg(cfg, source)
    comm.check(X_loc.device)
    return _run(X_loc, state, source, cfg, epoch_words, generator, valid,
                comm, coff)


# ---------------------------------------------------------------------------
# slice-batched dense runs (core.kv_cluster's refinement)
# ---------------------------------------------------------------------------

def _move_step_slices(Xf, st: BKMState, idx, k, cfg: EngineConfig, active):
    """``_move_step`` with the dense source for all P slices at once, in
    place on the flat state: ``Xf`` (P·n, d), ``st.assign`` (P·n,) slice-
    local ids, ``st.D`` (P·k, d), ``st.cnt`` (P·k,), ``st.moves`` (P,);
    ``idx`` (P, B) flat row ids; ``active`` (P,) bool or None (a slice
    that has stopped moves nothing).  One ``bmm`` scores every slice; the
    leaver guard and the two scatters use flat ``s·k + cluster`` ids."""
    P, B = idx.shape
    d = Xf.shape[1]
    rows = idx.reshape(-1)
    xb = Xf[rows].view(P, B, d)
    u = st.assign[rows].view(P, B)
    moved, want_v = _score_dense(xb, u, st.D.view(P, k, d),
                                 st.cnt.view(P, k), cfg.mode, cfg.eps)
    if active is not None:
        moved = moved & active[:, None]
    off = torch.arange(P, device=Xf.device)[:, None] * k
    ul = (u.long() + off).reshape(-1)
    moved = moved.reshape(-1)
    leav = torch.zeros((P * k,), dtype=torch.float32, device=Xf.device)
    leav.index_add_(0, ul, moved.float())
    moved = moved & ((st.cnt - leav) >= 1.0)[ul]
    v = torch.where(moved.view(P, B), want_v, u)
    w = moved.float()
    gx = xb.reshape(P * B, d) * w[:, None]
    both = torch.cat([ul, (v.long() + off).reshape(-1)])
    st.D.index_add_(0, both, torch.cat([-gx, gx]))
    st.cnt.index_add_(0, both, torch.cat([-w, w]))
    st.assign[rows] = v.reshape(-1)
    st.moves.add_(moved.view(P, B).sum(dim=1, dtype=torch.int32))


def run_slices(X: torch.Tensor, assign: torch.Tensor, k: int,
               cfg: EngineConfig, *, epoch_words=None,
               generator: Optional[torch.Generator] = None) -> BKMState:
    """``run`` with the dense source over P independent slices at once.

    X (P, n, d), assign (P, n) (cluster ids in [0, k) per slice).  Slice s
    visits its rows in the Feistel order of its own words —
    ``epoch_words`` (P, iters, 4), e.g. the reference's
    ``jax.random.bits(fold_in(key_s, t), (4,))``, or drawn from
    ``generator`` (a CPU ``torch.Generator``) — and equals ``run`` on
    ``X[s]`` with ``dense_source()`` and those words: assignments and
    counts exactly, D to f32 rounding (on the CPU, bit for bit).  Each
    move step is one batched step over all slices, so an epoch launches
    as many kernels as one slice's epoch, not P times as many.

    ``min_move_frac``: a slice stops after the first epoch whose moves are
    at most ``min_move_frac * n`` (it moves nothing after).  With
    ``min_move_frac >= 0`` the run reads every slice's stop flag once an
    epoch (one host sync, through ``obs.syncs.read``) and ends when all
    have stopped; with ``min_move_frac < 0`` nothing can stop it, and it
    reads nothing: 0 host syncs.  Returns the final state with slice axes:
    assign (P, n) int32, D (P, k, d), cnt (P, k), moves (P,) (the last
    epoch's).  Telemetry, shards and the bf16 payload are not offered
    here.
    """
    _check_cfg(cfg, dense_source())
    if cfg.telemetry or cfg.shards != 1 or cfg.payload_bf16:
        raise NotImplementedError("run_slices: telemetry, shards and "
                                  "payload_bf16 are not offered")
    if epoch_words is None and generator is None:
        raise ValueError("pass epoch_words or a generator")
    P, n, d = X.shape
    dev = X.device
    Xf = X.float().reshape(P * n, d)
    a = assign.to(device=dev, dtype=torch.int32).reshape(-1).clone()
    flat = a.long() + (torch.arange(P * n, device=dev) // n) * k
    stats = cluster_stats(Xf, flat, P * k)
    st = BKMState(a, stats.D, stats.cnt,
                  torch.zeros((P,), dtype=torch.int32, device=dev))
    bs = min(cfg.batch_size, n)
    nb = max(n // bs, 1)
    thresh = cfg.min_move_frac * n
    active = (torch.ones((P,), dtype=torch.bool, device=dev)
              if thresh >= 0 else None)
    if epoch_words is None:
        epoch_words = permute.draw_words(
            generator, P * cfg.iters * permute.ROUNDS).view(P, cfg.iters, -1)
    off = (torch.arange(P, device=dev) * n)[:, None]
    for t in range(cfg.iters):
        # the slices' visit orders, made on the CPU (no host sync)
        order = permute.epoch_orders(
            [epoch_words[s][t] for s in range(P)], n, dev) + off
        st.moves.zero_()
        for i in range(nb):
            _move_step_slices(Xf, st, order[:, i * bs:(i + 1) * bs], k, cfg,
                              active)
        if active is not None:
            active &= st.moves > thresh
            if not bool(syncs.read(active.any())):
                break
    return BKMState(st.assign.view(P, n), st.D.view(P, k, d),
                    st.cnt.view(P, k), st.moves)
