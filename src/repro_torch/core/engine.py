"""Clustering engine, single device: candidate -> score -> move.

Counterpart of ``repro.core.engine`` (its single-device branch).  Per
mini-batch: the candidate clusters are those of the samples' κ graph
neighbours (looked up in the epoch-start assignment), ``gather_score``
scores them (ΔI of paper Eqn. 3, or the lloyd distance), the best move is
accepted, a leaver guard keeps every cluster non-empty, and the running
statistics (D, cnt) take the moves as two ``index_add_`` scatters.

Differences from the reference, all stated:

* State is updated in place (``BKMState`` tensors are mutated by ``epoch``
  and ``run``); the reference's arrays are immutable and donated.
* The D/cnt scatter is atomic on CUDA, so D depends on the order of the
  adds in its last ulp; the counts and the leaver guard's counts are
  integer-valued and exact.  Scores therefore match the reference to float32
  rounding, and a run can diverge from it once one borderline move flips.
* Host syncs: ``run`` reads each epoch's move count (with its distortion)
  once, for the ``min_move_frac`` early stop — ONE host sync per epoch —
  where the reference's in-trace ``while_loop`` syncs once per run.  The
  read goes through ``obs.syncs.read``, so an active ``sync_counter``
  counts it.  An epoch itself syncs nothing: the visit order is made on the
  CPU and copied without blocking (``core.permute``).
* Telemetry (``EngineConfig(telemetry=True)``): ``run`` fills one row per
  epoch on the device (``RunResult.telemetry``) and adds no host sync; the
  rows stay on the device.  With it off, the move step launches nothing
  more than it does without the option.

Candidate sources: ``graph`` (the clusters of the sample's κ neighbours),
``dense`` (all k clusters, scored with one ``(B, k)`` matmul, as the
reference's ``_score_dense`` computes them outside any kernel; PQ training
runs it in lloyd mode) and ``probe`` (the p clusters whose centroids
``D / max(cnt, 1)`` lie nearest the sample, from ``probe_centroids``, plus
the sample's own cluster as the last column, so empty cells cannot crowd
it out).  The probe kernel's cap p <= 128 is a stated difference:
``probe_source`` raises above it.  Out of scope (raise
``NotImplementedError``): ``shards > 1``, ``payload_bf16`` and ``valid``
masks.  ``sparse_updates`` is accepted: on one device it is the same plain
scatter (``repro/core/engine.py:620-622``).

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
from repro_torch.core.objective import cluster_stats
from repro_torch.kernels import ops as kops
from repro_torch.kernels.centroid_assign import MAX_P
from repro_torch.obs import syncs
from repro_torch.obs import telemetry as obs_tel


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
    sparse_updates: bool = False  # one device: the same plain scatter
    payload_bf16: bool = False
    shards: int = 1
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
    if cfg.shards != 1:
        raise NotImplementedError("shards > 1: not ported yet")
    if cfg.payload_bf16:
        raise NotImplementedError("payload_bf16: not ported yet")
    if source.kind not in ("graph", "dense", "probe"):
        raise NotImplementedError(f"{source.kind} source: not ported yet")
    if cfg.mode not in ("bkm", "lloyd"):
        raise ValueError(f"mode must be 'bkm' or 'lloyd', got {cfg.mode!r}")


def _score_gathered(xb, u, cand, D, cnt, mode, eps, force):
    """Best move per sample among gathered candidates -> (moved, want_v)."""
    is_self = cand == u[:, None]
    if mode == "bkm":
        score = kops.gather_score(xb, u, cand, D, cnt, mode="bkm",
                                  force=force)
        score = torch.where(is_self, float("-inf"), score)
        best = score.argmax(dim=1)
        moved = score.gather(1, best[:, None])[:, 0] > eps
    else:
        d2 = kops.gather_score(xb, u, cand, D, cnt, mode="lloyd",
                               force=force)
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
        score = torch.where(cols == ul[..., None], float("-inf"), score)
        best = score.argmax(dim=-1)                       # first maximum
        moved = score.gather(-1, best[..., None])[..., 0] > eps
    else:
        csq_n = torch.clamp(cnt, min=1.0)
        d2 = (dsq[..., None, :] / (csq_n * csq_n)[..., None, :]
              - 2.0 * dots / csq_n[..., None, :])
        d2 = torch.where(cnt[..., None, :] > 0, d2, float("inf"))
        best = d2.argmin(dim=-1)                          # first minimum
        moved = best != ul
    return moved, best.to(torch.int32)


def _move_step(X, st: BKMState, idx, lookup, source, cfg: EngineConfig,
               cbuf=None, proposed=None):
    """One batched candidate -> score -> move step, in place on ``st``.

    ``cbuf`` (k, d): the probe source's centroid buffer, refilled here with
    ``D / max(cnt, 1)`` from the live statistics.  ``proposed`` (() int32,
    or None): adds the batch's moves before the leaver guard."""
    k = st.cnt.shape[0]
    xb = X[idx]
    u = st.assign[idx]
    if source.kind == "dense":
        moved, want_v = _score_dense(xb, u, st.D, st.cnt, cfg.mode, cfg.eps)
    else:
        if source.kind == "probe":
            torch.div(st.D, torch.clamp(st.cnt, min=1.0)[:, None], out=cbuf)
            ids, _ = kops.probe_centroids(xb, cbuf, source.p,
                                          force=cfg.force)
            # the sample's own cluster stays a candidate:
            # empty cells, centroids at the origin, can crowd it out
            cand = torch.cat([ids.to(torch.int32), u[:, None]], dim=1)
        else:
            cand = lookup[source.G[idx]]                  # (B, κ) int32
        moved, want_v = _score_gathered(xb, u, cand, st.D, st.cnt, cfg.mode,
                                        cfg.eps, cfg.force)
    if proposed is not None:
        proposed.add_(moved.sum(dtype=torch.int32))
    # leaver guard: block all leavers of a cluster whose leaver count would
    # reach its population (conservative, rare)
    ul = u.long()
    leav = torch.zeros((k,), dtype=torch.float32, device=X.device)
    leav.index_add_(0, ul, moved.float())
    moved = moved & ((st.cnt - leav) >= 1.0)[ul]
    v = torch.where(moved, want_v, u)
    w = moved.float()
    gx = xb * w[:, None]
    both = torch.cat([ul, v.long()])
    st.D.index_add_(0, both, torch.cat([-gx, gx]))
    st.cnt.index_add_(0, both, torch.cat([-w, w]))
    st.assign[idx] = v
    st.moves.add_(moved.sum(dtype=torch.int32))


def epoch(X: torch.Tensor, state: BKMState, source: CandidateSource,
          words: permute.Words, cfg: EngineConfig = EngineConfig(),
          proposed: Optional[torch.Tensor] = None) -> BKMState:
    """One pass over a shuffled view of the data in mini-batches.

    Visits ``n // bs * bs`` samples in the Feistel order of ``words`` (the
    epoch's 4 subkey words).  Candidates come from the epoch-start
    assignment.  Updates ``state`` in place and returns it with ``moves``
    set to this epoch's accepted moves.  No host sync.

    ``proposed``: a side tensor (() int32 on X's device) that receives the
    epoch's moves proposed before the leaver guard (zeroed first) — how
    ``run`` fills its telemetry; the reference's ``_epoch_impl`` returns
    that count beside the state.  None (the default) counts nothing, with
    ``cfg.telemetry`` on or off.
    """
    _check_cfg(cfg, source)
    n = X.shape[0]
    bs = min(cfg.batch_size, n)
    nb = max(n // bs, 1)
    order = permute.epoch_order(words, n, X.device)
    lookup = state.assign.clone()         # epoch-start snapshot
    cbuf = torch.empty_like(state.D) if source.kind == "probe" else None
    state.moves.zero_()
    if proposed is not None:
        proposed.zero_()
    for i in range(nb):
        _move_step(X, state, order[i * bs:(i + 1) * bs], lookup, source, cfg,
                   cbuf, proposed)
    return state


def stats_distortion(xsq_total, D, cnt, n) -> torch.Tensor:
    """Distortion in O(k·d) from the running statistics (paper Eqn. 2/4)."""
    dsq = (D * D).sum(-1)
    obj = torch.where(cnt > 0, dsq / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(dsq)).sum()
    return (xsq_total - obj) / n


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


def run(X: torch.Tensor, state: BKMState, source: CandidateSource,
        cfg: EngineConfig, *, epoch_words: Optional[Sequence] = None,
        generator: Optional[torch.Generator] = None) -> RunResult:
    """Multi-epoch run with the ``min_move_frac`` early stop.

    ``epoch_words`` (iters, 4) gives each epoch's subkey words (the
    reference's ``jax.random.bits(fold_in(key, t), (4,))``); otherwise they
    are drawn from ``generator`` (a CPU ``torch.Generator``).  Host syncs:
    exactly one per epoch run (its move count and distortion are read
    together for the early stop, through ``obs.syncs.read``); the final
    distortion stays on device, and so does the telemetry.
    """
    _check_cfg(cfg, source)
    if epoch_words is None and generator is None:
        raise ValueError("pass epoch_words or a generator")
    n = X.shape[0]
    xsq_total = (X.float() ** 2).sum()
    thresh = cfg.min_move_frac * n
    hist, mhist = [], []
    reads = 0
    tel = obs_tel.init(cfg.iters, X.device) if cfg.telemetry else None
    prop = (torch.zeros((), dtype=torch.int32, device=X.device)
            if cfg.telemetry else None)
    for t in range(cfg.iters):
        words = (epoch_words[t] if epoch_words is not None
                 else permute.draw_words(generator))
        epoch(X, state, source, words, cfg, prop)
        dist = stats_distortion(xsq_total, state.D, state.cnt, n)
        if tel is not None:
            obs_tel.record(
                tel, t, moves=state.moves, proposed=prop,
                empty_clusters=(state.cnt <= 0.0).sum(dtype=torch.int32),
                distortion=dist,
                hit_rate=state.moves.float() / torch.clamp(prop.float(),
                                                           min=1.0))
        m, dv = syncs.read(torch.stack([state.moves.double(),
                                        dist.double()])).tolist()
        reads += 1
        hist.append(dv)
        mhist.append(int(m))
        if m <= thresh:
            break
    final = stats_distortion(xsq_total, state.D, state.cnt, n)
    return RunResult(state, hist, mhist, len(hist), final, reads, tel)


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
    epoch's).  Telemetry is not offered here.
    """
    _check_cfg(cfg, dense_source())
    if cfg.telemetry:
        raise NotImplementedError("run_slices: telemetry is not offered")
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
