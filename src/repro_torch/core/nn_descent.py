"""NN-Descent (Dong et al., WWW 2011): the paper's KGraph baseline.

Counterpart of ``repro.core.nn_descent``: a thin adapter over
``core.graph_build`` with ``source="descent"``.  Each round offers every row
a fixed-size sample of its neighbours' neighbours plus approximate reverse
neighbours; exact distances are merged into its top-κ list
(``kernels.ops.refine_merge`` for κ <= 64).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device
from repro_torch.core.knn_graph import KnnGraph


def nn_descent(X, kappa: int, *, iters: int = 10,
               sample: Optional[int] = None,
               generator: Optional[torch.Generator] = None, draws=None,
               chunk: int = 4096, force: Optional[str] = None,
               device: DeviceLike = None) -> KnnGraph:
    """Approximate KNN graph by NN-Descent: (n, κ) ids and squared distances.

    Runs on ``device`` (default ``cuda``; raises without one).  Randomness:
    ``draws`` (``graph_build.DescentDraws``) or ``generator`` (a CPU
    ``torch.Generator``).  Tiny inputs are clamped as in the reference:
    n <= 1 gives an all-(-1, inf) graph, and rows of n <= κ carry -1 tails
    past their n - 1 possible neighbours.
    """
    from repro_torch.core.graph_build import GraphBuildConfig, build_graph
    Xd = as_f32(X, resolve_device(device))
    n = Xd.shape[0]
    if n <= 1:
        return KnnGraph(
            torch.full((n, kappa), -1, dtype=torch.int32, device=Xd.device),
            torch.full((n, kappa), float("inf"), device=Xd.device))
    cfg = GraphBuildConfig(kappa=kappa, source="descent", tau=iters,
                           sample=sample or 2 * kappa, chunk=chunk,
                           force=force)
    graph, _ = build_graph(Xd, cfg, generator=generator, draws=draws)
    return graph
