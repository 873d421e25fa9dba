"""KNN-graph construction (paper Alg. 3), single device.

Counterpart of ``repro.core.graph_build`` with ``source="partition"``.  The
build pads n up to ``k0 * xi`` with phantom copies of random rows, seeds
every row's list with κ random candidates, then runs τ rounds of:

  partition   an equal-size 2M tree into k0 clusters (``two_means_dist``);
  guided      from round 1 on, one graph-guided engine epoch over the
              partition (the "intertwined evolving" step);
  members     a fixed-capacity member table plus a spill list
              (``members_table_local``);
  refine      exact distances from each row to its co-members, merged into
              its top-κ list (``kernels.ops.refine_merge``; the sort-based
              ``merge_topk`` when κ > 64).

The reference runs the rounds inside one ``lax.scan`` trace; the port runs
them eagerly, with no host sync inside a build (the per-round diagnostics
stay on the device).  Out of this slice: ``source="descent"``,
``GraphBuilder`` (meshes), ``shards > 1`` and ``telemetry``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._device import to_device
from repro_torch.core import engine
from repro_torch.core.knn_graph import (KnnGraph, members_table_local,
                                        merge_topk, random_graph)
from repro_torch.core.objective import cluster_stats
from repro_torch.core.permute import draw_words
from repro_torch.core.two_means import draw_salts, two_means_dist
from repro_torch.kernels import ops as kops
from repro_torch.kernels.refine_merge import source_norms

# beyond this list width the sort-based merge_topk replaces the kernel
_WIDE_KAPPA = 64


class BuildDiagnostics(NamedTuple):
    overflow: torch.Tensor      # (tau,) int32 members beyond the table cap
    guided_moves: torch.Tensor  # (tau,) int32 moves of the guided pass


class GraphBuildConfig(NamedTuple):
    kappa: int = 16
    source: str = "partition"
    xi: int = 64                # target cluster size
    tau: int = 8                # rounds
    cap_factor: int = 2         # member-table capacity = cap_factor * xi
    bkm_batch: int = 1024       # guided pass batch size
    guided: bool = True
    chunk: int = 1024           # refine row chunk
    shards: int = 1
    force: Optional[str] = None  # kernel dispatch override (None | 'ref')
    telemetry: bool = False
    spill: int = 8              # overflow spill width


class BuildDraws(NamedTuple):
    """Every random draw of one build (the reference's jax.random draws).

    pad_extra (n_pad - n,) real row ids of the phantom rows; init_ids
    (n_pad, κ) random initial neighbour ids (!= own real id); salts
    (tau, log2 k0, 2) tree salts; epoch_words (tau, 4) guided-pass words.
    """

    pad_extra: torch.Tensor
    init_ids: torch.Tensor
    salts: torch.Tensor
    epoch_words: torch.Tensor


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _plan(n: int, cfg: GraphBuildConfig) -> Tuple[int, int]:
    """(k0, n_pad) of the padded partition layout."""
    if cfg.xi < 1:
        raise ValueError(f"xi={cfg.xi} must be >= 1")
    k0 = _next_pow2(max((n + cfg.xi - 1) // cfg.xi, 1))
    return k0, k0 * cfg.xi


def draw_build(n: int, cfg: GraphBuildConfig,
               generator: torch.Generator) -> BuildDraws:
    """All of a build's draws from one CPU generator."""
    k0, n_pad = _plan(n, cfg)
    extra = torch.randint(0, n, (n_pad - n,), generator=generator)
    init = random_graph(n, cfg.kappa, generator,
                        own=torch.cat([torch.arange(n), extra]), device="cpu")
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


def build_graph(X: torch.Tensor, cfg: GraphBuildConfig, *,
                generator: Optional[torch.Generator] = None,
                draws: Optional[BuildDraws] = None
                ) -> Tuple[KnnGraph, BuildDiagnostics]:
    """Single-device build on X's device: (KnnGraph (n, κ), diagnostics).

    Randomness: ``draws`` if given, else ``draw_build(n, cfg, generator)``.
    No host sync.
    """
    if cfg.source != "partition":
        raise NotImplementedError(f"source={cfg.source!r}: not ported yet")
    if cfg.shards != 1:
        raise NotImplementedError("shards > 1: not ported yet")
    if cfg.telemetry:
        raise NotImplementedError("telemetry: not ported yet")
    n, _ = X.shape
    dev = X.device
    k0, n_pad = _plan(n, cfg)
    if draws is None:
        if generator is None:
            raise ValueError("pass draws or a generator")
        draws = draw_build(n, cfg, generator)
    Xf = X.float().contiguous()
    real_id = to_device(torch.cat([torch.arange(n), torch.as_tensor(
        draws.pad_extra).long().cpu()]), dev)
    X_pad = Xf[real_id].contiguous() if n_pad > n else Xf
    ysq = source_norms(X_pad)
    row_ids = torch.arange(n_pad, device=dev)
    kappa = cfg.kappa

    g_ids = torch.full((n_pad, kappa), -1, dtype=torch.int32, device=dev)
    g_d = torch.full((n_pad, kappa), float("inf"), device=dev)
    # init = the same refinement against κ random candidates per row
    cand0 = to_device(torch.as_tensor(draws.init_ids).to(torch.int32), dev)
    g_ids, g_d = _refine_rows(X_pad, torch.clamp(cand0, min=0), cand0,
                              g_ids, g_d, X_pad, ysq, cfg.chunk, cfg.force)

    cap = cfg.cap_factor * cfg.xi
    ecfg = engine.EngineConfig(batch_size=cfg.bkm_batch, sparse_updates=True,
                               force=cfg.force)
    overflow, moves = [], []
    for t in range(cfg.tau):
        assign = two_means_dist(X_pad, row_ids, k0, salts=draws.salts[t])
        mv = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.guided and t > 0:
            # the intertwined evolving step: one graph-guided engine epoch
            # over this round's partition (round 0's graph is still random)
            D, cnt = cluster_stats(X_pad, assign, k0)
            st = engine.BKMState(assign, D, cnt, mv)
            engine.epoch(X_pad, st, engine.graph_source(g_ids),
                         draws.epoch_words[t], ecfg)
            assign = st.assign
        table_T, spill_ids, ovf = members_table_local(assign, row_ids, k0,
                                                      cap, cfg.spill)
        cand_rows = torch.cat([table_T[:, assign.long()].T,
                               spill_ids[None, :].expand(n_pad, -1)], dim=1)
        cand_ids = torch.where(
            cand_rows >= 0, real_id[torch.clamp(cand_rows, min=0).long()],
            -1).to(torch.int32)
        # mask self and phantoms of self; phantom duplicates dedupe in merge
        cand_ids = torch.where(cand_ids == real_id[:, None].to(torch.int32),
                               -1, cand_ids)
        g_ids, g_d = _refine_rows(X_pad,
                                  torch.clamp(cand_rows, min=0).contiguous(),
                                  cand_ids.contiguous(), g_ids, g_d, X_pad,
                                  ysq, cfg.chunk, cfg.force)
        overflow.append(ovf)
        moves.append(mv)
    diag = BuildDiagnostics(
        torch.stack(overflow) if overflow else
        torch.zeros((0,), dtype=torch.int32, device=dev),
        torch.stack(moves) if moves else
        torch.zeros((0,), dtype=torch.int32, device=dev))
    return KnnGraph(g_ids[:n].contiguous(), g_d[:n].contiguous()), diag
