"""Boost k-means (BKM): a thin adapter over the clustering engine.

Counterpart of ``repro.core.bkm``: ``run_bkm`` is the full all-k-candidates
baseline (``G=None``: the dense source, one ``(B, k)`` product a batch) or
the graph-guided variant (``G``: each sample scores only its neighbours'
clusters, GK-means' Alg. 2).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device, to_device
from repro_torch.core.engine import (BKMState, EngineConfig, dense_source,
                                     graph_source, init_state, run)

__all__ = ["BKMState", "init_state", "run_bkm"]


def run_bkm(X, assign0, k: int, *, iters: int, batch_size: int,
            generator: Optional[torch.Generator] = None,
            epoch_words: Optional[Sequence] = None, G=None,
            mode: str = "bkm", eps: float = 0.0,
            force: Optional[str] = None, device: DeviceLike = None
            ) -> Tuple[BKMState, List[float]]:
    """Run all ``iters`` epochs from ``assign0``: (final state, per-epoch
    distortion).  Each epoch's visit order comes from ``epoch_words``
    (iters, 4) or ``generator``; one host sync per epoch (``engine.run``).
    """
    dev = resolve_device(device)
    Xf = as_f32(X, dev)
    a0 = to_device(torch.as_tensor(assign0).to(torch.int32), dev)
    source = (dense_source() if G is None else
              graph_source(to_device(torch.as_tensor(G), dev)))
    # min_move_frac < 0: never stop early (fixed-length history)
    cfg = EngineConfig(batch_size=min(batch_size, Xf.shape[0]), mode=mode,
                       eps=eps, iters=iters, min_move_frac=-1.0, force=force)
    res = run(Xf, init_state(Xf, a0, k), source, cfg,
              epoch_words=epoch_words, generator=generator)
    return res.state, res.history
