"""GK-means (paper Alg. 2): graph-driven boost k-means, end to end.

Counterpart of ``repro.core.gkmeans``.  Three stages: (1) build the KNN
graph with Alg. 3 (``knn_graph.build_knn_graph``), (2) initialise k clusters
with the 2M tree (``two_means.two_means_tree``), (3) run graph-guided engine
epochs where each sample scores only its κ neighbours' clusters.

Host syncs: one per engine epoch (the early-stop test, see ``core.engine``)
plus one for the final distortion — ``epochs + 1`` in all, counted in
``GKMeansResult.host_syncs``; the graph build and the initialisation sync
nothing.  Each of those reads goes through ``obs.syncs.read``, so under
``obs.syncs.sync_counter()`` the counter gives the same number and any
other sync raises.  (The ``span`` timers synchronise the device at their
edges to time it; sync-debug mode does not report that.)  With
``telemetry=True`` the engine's per-epoch rows come back in the same final
read as the distortion.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device, to_device
from repro_torch.core import engine
from repro_torch.core.graph_build import BuildDiagnostics
from repro_torch.core.knn_graph import KnnGraph, build_knn_graph
from repro_torch.core.two_means import pad_plan, two_means_tree
from repro_torch.obs import syncs
from repro_torch.obs import telemetry as obs_tel
from repro_torch.obs.timing import span


@dataclass
class GKMeansResult:
    assign: torch.Tensor       # (n,) int32
    centroids: torch.Tensor    # (k, d) float32
    k: int
    distortion: float
    history: List[float]       # per-epoch distortion
    moves: List[int]           # per-epoch accepted moves
    graph: Optional[KnnGraph]
    seconds: dict = field(default_factory=dict)
    graph_diag: Optional[BuildDiagnostics] = None
    host_syncs: int = 0
    # the engine's per-epoch Telemetry on the CPU (gk_means(telemetry=True);
    # else None)
    telemetry: Optional[obs_tel.Telemetry] = None


def _tree_init(X: torch.Tensor, k: int,
               generator: Optional[torch.Generator], *, extra=None,
               seeds=None) -> torch.Tensor:
    """Equal-size 2M-tree initialisation, padding (n, k) as needed: the
    padding rows ``extra`` and the tree's ``seeds`` are drawn from
    ``generator`` when omitted."""
    n = X.shape[0]
    n2, k2 = pad_plan(n, k)
    if n2 > n:
        if extra is None:
            extra = torch.randint(0, n, (n2 - n,), generator=generator)
        Xp = torch.cat([X, X[to_device(torch.as_tensor(extra).long(),
                                       X.device)]])
    else:
        Xp = X
    return two_means_tree(Xp, k2, seeds=seeds, generator=generator)[:n]


def gk_means(X, k: int, *, kappa: int = 32, xi: int = 64, tau: int = 8,
             iters: int = 20, batch_size: int = 1024,
             generator: Optional[torch.Generator] = None,
             graph: Optional[KnnGraph] = None, mode: str = "bkm",
             min_move_frac: float = 1e-4, guided_graph: bool = True,
             telemetry: bool = False, force: Optional[str] = None,
             device: DeviceLike = None) -> GKMeansResult:
    """Cluster X (n, d) into k clusters (k rounded up to a power of two).

    Runs on ``device`` (default ``cuda``; raises when there is none — pass
    ``device="cpu"`` for the CPU).  All randomness comes from ``generator``
    (a CPU ``torch.Generator``; seeded from 0 when omitted), so two runs
    from equal generators make the same draws.  ``graph``: a pre-built
    KnnGraph; None builds Alg. 3's own.  ``force="ref"`` runs the plain
    PyTorch versions of the kernels.  ``telemetry``: the engine's per-epoch
    rows in ``GKMeansResult.telemetry``, as the reference's (the graph build
    is not instrumented here).
    """
    dev = resolve_device(device)
    X = as_f32(X, dev)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n, _ = X.shape
    _, k2 = pad_plan(n, k)

    sec = {}
    gdiag = None
    with span("graph", sec, dev):
        if graph is None:
            graph, gdiag = build_knn_graph(
                X, kappa, xi=xi, tau=tau, generator=generator,
                guided=guided_graph, force=force, device=dev,
                return_diagnostics=True)
    with span("init", sec, dev):
        assign = _tree_init(X, k2, generator)
    with span("iter", sec, dev):
        source = engine.graph_source(graph.ids)
        state = engine.init_state(X, assign, k2)
        cfg = engine.EngineConfig(batch_size=min(batch_size, n), mode=mode,
                                  iters=iters, min_move_frac=min_move_frac,
                                  force=force, telemetry=telemetry)
        res = engine.run(X, state, source, cfg, generator=generator)
        C = res.state.D / torch.clamp(res.state.cnt, min=1.0)[:, None]
        # the last host sync: the final distortion, with the telemetry
        # packed beside it in f64 (one transfer)
        if res.telemetry is None:
            final, tel = float(syncs.read(res.final)), None
        else:
            host = syncs.read(torch.cat([res.final.double().view(1),
                                         obs_tel.pack(res.telemetry)]))
            final = float(host[0])
            tel = obs_tel.unpack(host[1:], res.telemetry.rows)
    return GKMeansResult(res.state.assign, C, k2, final, res.history,
                         res.moves, graph, sec, gdiag, res.host_syncs + 1,
                         tel)
