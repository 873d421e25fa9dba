"""KNN-graph construction, single device: one refinement loop, two sources.

Counterpart of ``repro.core.graph_build``.  Every round offers each row a
set of candidate rows, computes exact distances to them and merges them
into its sorted, id-deduped top-κ list (``_refine_rows``:
``kernels.ops.refine_merge``, or the sort-based ``merge_topk`` when
κ > 64).  Rows are seeded with κ random candidates first
(``random_init``; closure k-means turns it off).  The candidate source:

* ``partition`` (paper Alg. 3).  The build pads n up to ``k0 * xi`` with
  phantom copies of random rows, then runs τ rounds of: an equal-size 2M
  tree into k0 clusters (``two_means_dist``); from round 1 on, one
  graph-guided engine epoch over the partition (the "intertwined evolving"
  step); a fixed-capacity member table plus a spill list
  (``members_table_local``); the refinement against co-members.
* ``descent`` (NN-Descent, the paper's KGraph baseline).  No padding.  Each
  round offers ``sample`` neighbours of neighbours and ``sample`` reverse
  neighbours: edge i -> j lands in a random slot of j's reverse list, and
  when two edges collide in a slot the larger source row wins
  (``scatter_reduce`` "amax", on any device; the reference's serial
  last-writer order gives the same winner).

The reference runs the rounds inside one ``lax.scan`` trace; the port runs
them eagerly, with no host sync inside a build (the per-round diagnostics
stay on the device).  ``GraphBuildConfig(telemetry=True)`` adds per-round
``Telemetry`` rows to the diagnostics, also on the device (``overflow``,
``guided_moves``, ``graph_updates`` and ``graph_mean_dist``, the last two
over all the build's rows, phantoms included, as the reference's are).

Topologies.  ``GraphBuilder(cfg, group=...)`` runs the build over a
``torch.distributed`` group: every rank passes the full X and gets the full
graph back, while the rounds work on the rank's contiguous block of the
padded rows.  X is gathered once per build (candidates may live on any
rank); the tree is ``two_means_dist`` over the group; the guided pass runs
``engine.sharded_epoch`` with cluster-sharded statistics; each rank tables
its own rows' cluster slots (``members_table_local`` with capacity
``cap / R`` and its spill list) and the round gathers the slices and the
spill lists and sums the overflow; the refinement is local.  With
``GraphBuildConfig(shards=R)`` one device emulates that R-way build: the
tree and the guided pass blocked the same way, R table slices, so the
result equals the group's (bit for bit on the CPU).  The descent source
ignores ``shards`` (its rounds have no blocked step); over a group its rows
must divide by the group size.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import to_device
from repro_torch.core import engine
from repro_torch.core.comm import Comm
from repro_torch.core.knn_graph import (KnnGraph, members_table_local,
                                        merge_topk, random_graph)
from repro_torch.core.objective import cluster_stats
from repro_torch.core.permute import draw_words
from repro_torch.core.two_means import TreeTopo, draw_salts, two_means_dist
from repro_torch.kernels import ops as kops
from repro_torch.kernels.refine_merge import source_norms
from repro_torch.obs import telemetry as obs_tel

# beyond this list width the sort-based merge_topk replaces the kernel
_WIDE_KAPPA = 64


class BuildDiagnostics(NamedTuple):
    overflow: torch.Tensor      # (tau,) int32 members beyond the table cap
    guided_moves: torch.Tensor  # (tau,) int32 moves of the guided pass
    # per-round Telemetry (tau rows) with cfg.telemetry, else None: the two
    # counters above plus graph_updates (list entries changed by the round)
    # and graph_mean_dist (mean finite list distance after it)
    telemetry: Optional[obs_tel.Telemetry] = None


class GraphBuildConfig(NamedTuple):
    kappa: int = 16
    source: str = "partition"   # 'partition' (Alg. 3) | 'descent' (KGraph)
    xi: int = 64                # partition: target cluster size
    tau: int = 8                # rounds (NN-Descent iterations for descent)
    cap_factor: int = 2         # member-table capacity = cap_factor * xi
    bkm_batch: int = 1024       # guided pass batch size
    guided: bool = True
    sample: int = 0             # descent: candidate half-width (0 -> 2κ)
    chunk: int = 1024           # refine row chunk
    shards: int = 1
    force: Optional[str] = None  # kernel dispatch override (None | 'ref')
    random_init: bool = True    # seed lists with κ random candidates
    telemetry: bool = False     # per-round Telemetry in BuildDiagnostics
    spill: int = 8              # overflow spill width


class BuildDraws(NamedTuple):
    """Every random draw of one build (the reference's jax.random draws).

    pad_extra (n_pad - n,) real row ids of the phantom rows; init_ids
    (n_pad, κ) random initial neighbour ids (!= own real id; None when
    ``random_init=False``); salts (tau, log2 k0, 2) tree salts; epoch_words
    (tau, 4) guided-pass words.
    """

    pad_extra: torch.Tensor
    init_ids: Optional[torch.Tensor]
    salts: torch.Tensor
    epoch_words: torch.Tensor


class DescentDraws(NamedTuple):
    """Every random draw of one descent build (the reference's draws).

    init_ids (n, κ) random initial neighbour ids (!= own id; None when
    ``random_init=False``); per round t, pick1[t] and pick2[t] (n, s): the
    neighbour column, then that neighbour's neighbour column, of each
    forward candidate; slot[t] (n, κ): the reverse-list slot of each edge.
    """

    init_ids: Optional[torch.Tensor]
    pick1: torch.Tensor
    pick2: torch.Tensor
    slot: torch.Tensor


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _plan(n: int, cfg: GraphBuildConfig) -> Tuple[int, int]:
    """(k0, n_pad) of the padded partition layout (descent never pads)."""
    if cfg.source != "partition":
        return 1, n
    if cfg.xi < 1:
        raise ValueError(f"xi={cfg.xi} must be >= 1")
    k0 = _next_pow2(max((n + cfg.xi - 1) // cfg.xi, 1))
    return k0, k0 * cfg.xi


def draw_build(n: int, cfg: GraphBuildConfig,
               generator: torch.Generator) -> BuildDraws:
    """All of a partition build's draws from one CPU generator."""
    k0, n_pad = _plan(n, cfg)
    extra = torch.randint(0, n, (n_pad - n,), generator=generator)
    init = random_graph(n, cfg.kappa, generator, own=torch.cat(
        [torch.arange(n), extra]), device="cpu") if cfg.random_init else None
    levels = k0.bit_length() - 1
    salts = torch.stack([draw_salts(levels, generator)
                         for _ in range(cfg.tau)]) if levels else \
        torch.zeros((cfg.tau, 0, 2), dtype=torch.int64)
    words = torch.stack([draw_words(generator) for _ in range(cfg.tau)])
    return BuildDraws(extra, init, salts, words)


def _refine_rows(x_own, rows, cand_ids, g_ids, g_d, Xsrc, ysq, chunk,
                 force):
    """Exact distances to C candidates merged into top-κ lists, by chunk."""
    B = x_own.shape[0]
    kappa = g_ids.shape[1]
    chunk = max(1, min(chunk, B))
    ids_out, d_out = [], []
    for s in range(0, B, chunk):
        sl = slice(s, s + chunk)
        if kappa > _WIDE_KAPPA:
            xo = x_own[sl]
            Y = Xsrc[rows[sl].long()]
            cd = ((Y - xo[:, None, :]) ** 2).sum(-1)
            cd = torch.where(cand_ids[sl] < 0, float("inf"), cd)
            i, d = merge_topk(g_ids[sl], g_d[sl], cand_ids[sl], cd, kappa)
        else:
            i, d = kops.refine_merge(x_own[sl], rows[sl], cand_ids[sl],
                                     g_ids[sl], g_d[sl], Xsrc, ysq=ysq,
                                     force=force)
        ids_out.append(i)
        d_out.append(d)
    return torch.cat(ids_out), torch.cat(d_out)


def _descent_round_draws(n: int, cfg: GraphBuildConfig, dev,
                         generator: Optional[torch.Generator],
                         draws: Optional[DescentDraws]
                         ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Each round's (pick1, pick2, slot) on ``dev``: the injected ``draws``,
    or drawn on ``dev`` from a generator seeded by ``generator`` (2·n·s + n·κ
    ids a round: drawn on the CPU they would cost seconds a round at
    n = 10^6)."""
    kappa, s = cfg.kappa, cfg.sample or 2 * cfg.kappa
    if draws is not None:
        for t in range(cfg.tau):
            yield tuple(to_device(torch.as_tensor(a[t]).long(), dev)
                        for a in (draws.pick1, draws.pick2, draws.slot))
        return
    # lint: boundary(a draw of the CPU generator: no device read)
    seed = int(torch.randint(0, 1 << 62, (), generator=generator))
    g = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(cfg.tau):
        yield (torch.randint(0, kappa, (n, s), generator=g, device=dev),
               torch.randint(0, kappa, (n, s), generator=g, device=dev),
               torch.randint(0, s, (n, kappa), generator=g, device=dev))


def descent_candidates(g_ids: torch.Tensor, pick1: torch.Tensor,
                       pick2: torch.Tensor, slot: torch.Tensor
                       ) -> torch.Tensor:
    """One NN-Descent round's (n, 2s) int32 candidate ids, own id -> -1.

    Forward: ``ids[ids[i, pick1], pick2]`` (neighbours of neighbours).
    Reverse: edge i -> j is written to slot ``slot[i, c]`` of j's list of s;
    of colliding edges the largest source row i wins (the reference's
    serial last-writer winner under its row-major order); unwritten slots
    stay -1.
    """
    n, kappa = g_ids.shape
    s = pick1.shape[1]
    dev = g_ids.device
    ids = torch.clamp(g_ids, min=0).long()
    mid = ids.gather(1, pick1)                             # (n, s)
    fwd = ids.view(-1)[mid * kappa + pick2]                # ids[mid, pick2]
    src = torch.arange(n, device=dev).repeat_interleave(kappa)
    rev = torch.full((n * s,), -1, dtype=torch.int64, device=dev)
    rev.scatter_reduce_(0, (ids * s + slot).view(-1), src, "amax",
                        include_self=True)
    cand = torch.cat([fwd, rev.view(n, s)], dim=1)
    own = torch.arange(n, device=dev)[:, None]
    return torch.where(cand == own, -1, cand).to(torch.int32)


def _check_layout(n: int, cfg: GraphBuildConfig, R: int) -> None:
    """Raise unless the build's rows, table and clusters divide R ways."""
    k0, n_pad = _plan(n, cfg)
    if n_pad % R:
        raise ValueError(f"{n_pad} build rows do not divide into {R} shards"
                         + (" (see core.distributed.usable_rows)"
                            if cfg.source == "descent" else ""))
    if cfg.source != "partition":
        return
    if (cfg.cap_factor * cfg.xi) % R:
        raise ValueError(f"member-table capacity {cfg.cap_factor * cfg.xi} "
                         f"must divide into {R} per-shard slices")
    if cfg.guided and k0 % R:
        raise ValueError(f"k0={k0} must divide into {R} cluster blocks for "
                         "the guided pass (raise xi or use fewer shards)")


def build_graph(X: torch.Tensor, cfg: GraphBuildConfig, *,
                generator: Optional[torch.Generator] = None,
                draws=None) -> Tuple[KnnGraph, BuildDiagnostics]:
    """Single-device build on X's device: (KnnGraph (n, κ), diagnostics).

    Randomness: ``draws`` if given (``BuildDraws`` for the partition
    source, ``DescentDraws`` for descent), else drawn from ``generator`` (a
    CPU ``torch.Generator``).  ``cfg.shards=R`` emulates an R-way group
    build (``GraphBuilder(cfg, group=...)``) on one device.  No host sync.
    """
    if cfg.source not in ("partition", "descent"):
        raise ValueError(f"source must be 'partition' or 'descent', got "
                         f"{cfg.source!r}")
    if cfg.shards < 1:
        raise ValueError(f"shards must be >= 1, got {cfg.shards}")
    if draws is None and generator is None:
        raise ValueError("pass draws or a generator")
    n = X.shape[0]
    if cfg.source == "descent":
        g_ids, g_d, diag = _build_descent(X, cfg, generator, draws)
    else:
        _check_layout(n, cfg, cfg.shards)
        g_ids, g_d, diag = _build_partition(X, cfg, generator, draws)
    return KnnGraph(g_ids[:n].contiguous(), g_d[:n].contiguous()), diag


def _init_lists(X_own, Xsrc, init_ids, n_rows, ysq, cfg):
    """Empty (-1, inf) lists of the ``n_rows`` rows ``X_own``, refined
    against κ random candidate rows of ``Xsrc`` per row when
    ``random_init``."""
    dev = X_own.device
    g_ids = torch.full((n_rows, cfg.kappa), -1, dtype=torch.int32, device=dev)
    g_d = torch.full((n_rows, cfg.kappa), float("inf"), device=dev)
    if not cfg.random_init:
        return g_ids, g_d
    cand0 = to_device(torch.as_tensor(init_ids).to(torch.int32), dev)
    return _refine_rows(X_own, torch.clamp(cand0, min=0), cand0, g_ids, g_d,
                        Xsrc, ysq, cfg.chunk, cfg.force)


def _round_telemetry(tel, t, g_ids, g_d, gi0, comm=None, **counts):
    """File round t's slots: the given counters, the list entries that
    differ from the round-start ids ``gi0``, and the mean finite list
    distance, both over all rows — over the group's rows with ``comm`` (no
    host sync; None passes through)."""
    if tel is None:
        return
    fin = torch.isfinite(g_d)
    upd = (g_ids != gi0).sum(dtype=torch.int32)
    dsum = torch.where(fin, g_d, 0.0).sum()
    dcnt = fin.sum().to(torch.float32)
    if comm is not None:
        upd, dsum, dcnt = comm.psum(upd), comm.fsum(dsum), comm.psum(dcnt)
    obs_tel.record(tel, t, graph_updates=upd,
                   graph_mean_dist=dsum / torch.clamp(dcnt, min=1.0),
                   **counts)


def _local_rows(n_rows: int, comm: Optional[Comm], dev):
    """(first row, rows) of this rank's block, all rows without a group."""
    B = n_rows if comm is None else n_rows // comm.size
    lo = 0 if comm is None else comm.rank * B
    return lo, torch.arange(lo, lo + B, device=dev)


def _build_descent(X, cfg, generator, draws, comm=None):
    n = X.shape[0]
    dev = X.device
    lo, row_ids = _local_rows(n, comm, dev)
    B = row_ids.shape[0]
    X_loc = X[lo:lo + B].float().contiguous()
    Xf = X_loc if comm is None else comm.all_gather(X_loc)
    ysq = source_norms(Xf)
    init = (None if not cfg.random_init else
            draws.init_ids if draws is not None else
            random_graph(n, cfg.kappa, generator, device="cpu"))
    if init is not None:
        init = torch.as_tensor(init)[lo:lo + B]
    g_ids, g_d = _init_lists(X_loc, Xf, init, B, ysq, cfg)
    tel = obs_tel.init(cfg.tau, dev) if cfg.telemetry else None
    for t, (pick1, pick2, slot) in enumerate(_descent_round_draws(
            n, cfg, dev, generator, draws)):
        G_full = g_ids if comm is None else comm.all_gather(g_ids)
        cand = descent_candidates(G_full, pick1, pick2, slot)[lo:lo + B]
        del pick1, pick2, slot, G_full
        gi0 = g_ids                  # _refine_rows returns new tensors
        g_ids, g_d = _refine_rows(X_loc, torch.clamp(cand, min=0), cand,
                                  g_ids, g_d, Xf, ysq, cfg.chunk, cfg.force)
        # overflow and guided_moves stay 0, as the reference's descent rows
        _round_telemetry(tel, t, g_ids, g_d, gi0, comm)
    zeros = torch.zeros((cfg.tau,), dtype=torch.int32, device=dev)
    return g_ids, g_d, BuildDiagnostics(zeros, zeros.clone(), tel)


def _guided_stats(X, assign, k0, topo: TreeTopo):
    """The guided pass's (D, cnt): per-shard composite sums added in shard
    order, and integer counts summed (the reference's ``_guided_stats``)."""
    D = topo.fsum_blocks(lambda xb, ab: cluster_stats(xb, ab, k0).D, X,
                         assign)
    cnt = torch.zeros((k0,), dtype=torch.int64, device=X.device)
    cnt.index_add_(0, assign.long(), torch.ones_like(assign, dtype=torch.int64))
    return D, topo.isum(cnt).to(torch.float32)


def _member_table(assign, row_ids, k0, cap, spill, R, comm):
    """(table_T (cap, k0), spill ids (R·spill,), overflow ()): each shard's
    (cap / R, k0) slice of its own rows and its spill list, stacked in
    shard order (gathered over the group)."""
    if comm is not None:
        tT, sp, ovf = members_table_local(assign, row_ids, k0, cap // R,
                                          spill)
        return comm.all_gather(tT), comm.all_gather(sp), comm.psum(ovf)
    if R == 1:
        return members_table_local(assign, row_ids, k0, cap, spill)
    B = assign.shape[0] // R
    parts = [members_table_local(assign[s * B:(s + 1) * B],
                                 row_ids[s * B:(s + 1) * B], k0, cap // R,
                                 spill) for s in range(R)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            torch.stack([p[2] for p in parts]).sum(dtype=torch.int32))


def _build_partition(X, cfg, generator, draws, comm=None):
    n, _ = X.shape
    dev = X.device
    k0, n_pad = _plan(n, cfg)
    R = comm.size if comm is not None else cfg.shards
    if draws is None:
        draws = draw_build(n, cfg, generator)
    Xf = X.float().contiguous()
    # lint: boundary(the build's draws are host values)
    real_id = to_device(torch.cat([torch.arange(n), torch.as_tensor(
        draws.pad_extra).long().cpu()]), dev)
    lo, row_ids = _local_rows(n_pad, comm, dev)
    B = row_ids.shape[0]
    X_loc = Xf[real_id[lo:lo + B]].contiguous() if n_pad > n or comm \
        else Xf
    # candidates may live on any rank: X is gathered once per build
    X_pad = X_loc if comm is None else comm.all_gather(X_loc)
    ysq = source_norms(X_pad)
    own_real = real_id[row_ids].to(torch.int32)
    init = (None if draws.init_ids is None
            else torch.as_tensor(draws.init_ids)[lo:lo + B])
    g_ids, g_d = _init_lists(X_loc, X_pad, init, B, ysq, cfg)

    cap = cfg.cap_factor * cfg.xi
    topo = TreeTopo(cfg.shards, comm)
    ecfg = engine.EngineConfig(batch_size=cfg.bkm_batch, sparse_updates=True,
                               shards=R if comm is None else 1,
                               force=cfg.force)
    overflow, moves = [], []
    tel = obs_tel.init(cfg.tau, dev) if cfg.telemetry else None
    for t in range(cfg.tau):
        assign = two_means_dist(X_loc, row_ids, k0, salts=draws.salts[t],
                                shards=R if comm is None else 1, comm=comm)
        mv = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.guided and t > 0:
            # the intertwined evolving step: one graph-guided engine epoch
            # over this round's partition (round 0's graph is still random)
            D, cnt = _guided_stats(X_loc, assign, k0, topo)
            src = engine.graph_source(g_ids)
            if comm is None:
                st = engine.BKMState(assign, D, cnt, mv)
                engine.epoch(X_loc, st, src, draws.epoch_words[t], ecfg)
            else:
                k0_loc = k0 // R
                coff = comm.rank * k0_loc
                st = engine.BKMState(assign, D[coff:coff + k0_loc].clone(),
                                     cnt, mv)
                engine.sharded_epoch(X_loc, st, src, draws.epoch_words[t],
                                     ecfg, comm, coff)
            assign = st.assign
        table_T, spill_ids, ovf = _member_table(assign, row_ids, k0, cap,
                                                cfg.spill, R, comm)
        cand_rows = torch.cat([table_T[:, assign.long()].T,
                               spill_ids[None, :].expand(B, -1)], dim=1)
        cand_ids = torch.where(
            cand_rows >= 0, real_id[torch.clamp(cand_rows, min=0).long()],
            -1).to(torch.int32)
        # mask self and phantoms of self; phantom duplicates dedupe in merge
        cand_ids = torch.where(cand_ids == own_real[:, None], -1, cand_ids)
        gi0 = g_ids                  # _refine_rows returns new tensors
        g_ids, g_d = _refine_rows(X_loc,
                                  torch.clamp(cand_rows, min=0).contiguous(),
                                  cand_ids.contiguous(), g_ids, g_d, X_pad,
                                  ysq, cfg.chunk, cfg.force)
        _round_telemetry(tel, t, g_ids, g_d, gi0, comm, overflow=ovf,
                         guided_moves=mv)
        overflow.append(ovf)
        moves.append(mv)
    diag = BuildDiagnostics(
        torch.stack(overflow) if overflow else
        torch.zeros((0,), dtype=torch.int32, device=dev),
        torch.stack(moves) if moves else
        torch.zeros((0,), dtype=torch.int32, device=dev), tel)
    return g_ids, g_d, diag


class GraphBuilder:
    """A graph build's config, bound once, on one device or over a group.

    ``build(X, generator=..., draws=...)`` runs ``build_graph`` (``group``
    None), or the group build (``group`` a ``torch.distributed``
    ProcessGroup, ``"world"`` for the default group, or a ``core.comm.Comm``
    taken as it is): every rank passes
    the same X and the same draws (or a generator in the same state) and
    gets the full graph and the diagnostics back.  The group's backend must
    match X's device (NCCL with ``cuda``, gloo with ``cpu``).  The padded
    rows, the member-table capacity and, for the guided pass, the k0
    clusters must divide by the group size (``ValueError`` otherwise).
    """

    def __init__(self, cfg: GraphBuildConfig, group=None):
        self.cfg = cfg
        self.comm = (None if group is None else group
                     if isinstance(group, Comm) else
                     Comm(None if group == "world" else group))
        self.shards = 1 if self.comm is None else self.comm.size

    def build(self, X: torch.Tensor, *,
              generator: Optional[torch.Generator] = None, draws=None
              ) -> Tuple[KnnGraph, BuildDiagnostics]:
        if self.comm is None:
            return build_graph(X, self.cfg, generator=generator, draws=draws)
        cfg = self.cfg
        if cfg.source not in ("partition", "descent"):
            raise ValueError(f"source must be 'partition' or 'descent', got "
                             f"{cfg.source!r}")
        if draws is None and generator is None:
            raise ValueError("pass draws or a generator")
        self.comm.check(X.device)
        n = X.shape[0]
        _check_layout(n, cfg, self.comm.size)
        fn = _build_descent if cfg.source == "descent" else _build_partition
        g_ids, g_d, diag = fn(X, cfg, generator, draws, self.comm)
        return (KnnGraph(self.comm.all_gather(g_ids)[:n].contiguous(),
                         self.comm.all_gather(g_d)[:n].contiguous()), diag)

    def __repr__(self):
        return (f"GraphBuilder(shards={self.shards}, "
                f"source={self.cfg.source!r}, cfg={self.cfg})")
