"""Closure k-means (Wang et al., CVPR 2012): the paper's fast baseline.

Counterpart of ``repro.core.closure``.  A sample's candidate clusters are
those of its leaf-mates across ``trees`` random equal-size partitions: an
unguided partition build with ``xi = leaf``, ``tau = trees`` and no random
init keeps each row's ``trees * (leaf - 1)`` nearest leaf-mates (κ = 93 at
the defaults, so the refinement takes ``merge_topk``).  It starts from the
2M tree, as GK-means does, and assigns by the nearest candidate centroid
(lloyd mode), through ``gather_score``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device
from repro_torch.core import engine
from repro_torch.core.gkmeans import _tree_init
from repro_torch.core.graph_build import (BuildDraws, GraphBuildConfig,
                                          build_graph)
from repro_torch.core.objective import centroids, cluster_stats
from repro_torch.core.two_means import pad_plan


class ClosureDraws(NamedTuple):
    """Every random draw of one closure run (the reference's draws): graph,
    the leaf-mate build's ``BuildDraws`` (no init ids); pad_extra (n2 - n,)
    rows that pad the tree init; tree_seeds, the 2M tree's (i1, i2)
    (``two_means.draw_tree_seeds``); epoch_words (iters, 4)."""

    graph: BuildDraws
    pad_extra: Optional[torch.Tensor]
    tree_seeds: Tuple[torch.Tensor, torch.Tensor]
    epoch_words: torch.Tensor


def _leafmate_graph(X: torch.Tensor, trees: int, leaf: int,
                    generator: Optional[torch.Generator],
                    force: Optional[str], draws: Optional[BuildDraws] = None
                    ) -> torch.Tensor:
    """(n, trees*(leaf-1)) nearest leaf-mate ids across ``trees`` trees.

    No random init: the lists hold only leaf-mates.  Any leaf size works
    (only the tree's cluster count must be a power of two)."""
    cfg = GraphBuildConfig(kappa=trees * (leaf - 1), source="partition",
                           xi=leaf, tau=trees, guided=False,
                           random_init=False, force=force)
    graph, _ = build_graph(X, cfg, generator=generator, draws=draws)
    return graph.ids


def closure_kmeans(X, k: int, *, iters: int = 20, trees: int = 3,
                   leaf: int = 32, batch_size: int = 1024,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[ClosureDraws] = None,
                   force: Optional[str] = None, device: DeviceLike = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[float]]:
    """(assign (n,) int32, centroids (k2, d), per-epoch distortion), k
    rounded up to a power of two.  Randomness: ``draws`` or ``generator``
    (a CPU ``torch.Generator``).  One host sync per epoch."""
    if draws is None and generator is None:
        raise ValueError("pass draws or a generator")
    dev = resolve_device(device)
    Xf = as_f32(X, dev)
    n = Xf.shape[0]
    _, k2 = pad_plan(n, k)
    dr = draws if draws is not None else ClosureDraws(None, None, None, None)
    mates = _leafmate_graph(Xf, trees, leaf, generator, force, dr.graph)
    assign = _tree_init(Xf, k2, generator, extra=dr.pad_extra,
                        seeds=dr.tree_seeds)
    state = engine.init_state(Xf, assign, k2)
    cfg = engine.EngineConfig(batch_size=min(batch_size, n), mode="lloyd",
                              iters=iters, min_move_frac=-1.0, force=force)
    res = engine.run(Xf, state, engine.graph_source(mates), cfg,
                     epoch_words=dr.epoch_words,
                     generator=generator)
    C = centroids(cluster_stats(Xf, res.state.assign, k2))
    return res.state.assign, C, res.history
