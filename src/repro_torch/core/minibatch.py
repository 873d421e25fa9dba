"""Mini-Batch k-means (Sculley, WWW 2010): the paper's speed baseline (§5).

Counterpart of ``repro.core.minibatch``.  Each step assigns a random batch
with one plain ``(B, k)`` product (the reference computes it outside any
kernel too) and moves each centre by its per-centre learning rate
``1 / count``.  The final assignment goes through
``kernels.ops.assign_centroids``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device, to_device
from repro_torch.core.lloyd import init_random
from repro_torch.kernels import ops as kops


def minibatch_kmeans(X, k: int, *, steps: int = 100, batch_size: int = 1024,
                     generator: Optional[torch.Generator] = None,
                     init_ids=None, batch_ids=None,
                     force: Optional[str] = None, device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(assign (n,) int32, centroids (k, d)) after ``steps`` updates.

    ``init_ids`` (k,) the random init's rows and ``batch_ids`` (steps, B)
    each step's rows (B = min(batch_size, n)); drawn from ``generator`` (a
    CPU ``torch.Generator``) when omitted and copied to the device once.
    No host sync.
    """
    dev = resolve_device(device)
    Xf = as_f32(X, dev)
    n, d = Xf.shape
    B = min(batch_size, n)
    if batch_ids is None and generator is None:
        raise ValueError("pass batch_ids or a generator")
    C = init_random(Xf, k, generator=generator, ids=init_ids, device=dev)
    if batch_ids is None:
        batch_ids = torch.randint(0, n, (steps, B), generator=generator)
    bids = to_device(torch.as_tensor(batch_ids).long(), dev)
    counts = torch.zeros((k,), device=dev)
    ones = torch.ones((B,), device=dev)
    for i in range(steps):
        xb = Xf[bids[i]]
        csq = (C * C).sum(-1)
        a = torch.argmin(csq[None, :] - 2.0 * (xb @ C.T), dim=1)
        bs = torch.zeros((k,), device=dev).index_add_(0, a, ones)
        bsum = torch.zeros((k, d), device=dev).index_add_(0, a, xb)
        counts = counts + bs
        # per-centre learning rate 1/counts: C += (bsum - bs*C) / counts
        C = C + torch.where((counts > 0)[:, None],
                            (bsum - bs[:, None] * C)
                            / torch.clamp(counts, min=1.0)[:, None], 0.0)
    assign, _ = kops.assign_centroids(Xf, C, force=force)
    return assign, C
