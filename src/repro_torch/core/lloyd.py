"""Traditional k-means (Lloyd) and its seedings: the paper's quality baseline.

Counterpart of ``repro.core.lloyd``.  Each draw can be injected: the random
init's row ids (the reference's ``jax.random.choice(..., replace=False)``, a
permutation prefix), and k-means++'s first row and its k - 1 uniforms (the
reference's weighted ``jax.random.choice``: ``searchsorted(cum, cum[-1] *
(1 - u))`` over the cumulative probabilities, side left).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, as_f32, resolve_device, to_device
from repro_torch.core import permute
from repro_torch.kernels import ops as kops


def init_random(X, k: int, *, generator: Optional[torch.Generator] = None,
                ids=None, device: DeviceLike = None) -> torch.Tensor:
    """(k, d) float32 centroids: k distinct rows of X.

    ``ids`` (k,) the rows; else the first k of a random permutation drawn
    from ``generator`` (a CPU ``torch.Generator``).
    """
    Xf = as_f32(X, resolve_device(device))
    if ids is None:
        if generator is None:
            raise ValueError("pass ids or a generator")
        ids = permute.random_rows(Xf.shape[0], k, generator)
    return Xf[to_device(torch.as_tensor(ids).long(), Xf.device)]


def init_kmeanspp(X, k: int, *, generator: Optional[torch.Generator] = None,
                  first=None, uniforms=None,
                  device: DeviceLike = None) -> torch.Tensor:
    """k-means++ seeding (Arthur & Vassilvitskii): (k, d) float32 centroids.

    Step i draws row ``searchsorted(cum, cum[-1] * (1 - uniforms[i - 1]))``
    with ``cum`` the cumulative sum of ``d2 / sum(d2)``, d2 the squared
    distance to the nearest centroid so far.  ``first`` (the first row) and
    ``uniforms`` (k - 1,) are drawn from ``generator`` when omitted, on the
    CPU, and copied once.  A host loop over k of a dozen small launches a
    step (one (n,) mat-vec, one cumsum, one searchsorted), with no host
    sync.
    """
    Xf = as_f32(X, resolve_device(device))
    dev = Xf.device
    n = Xf.shape[0]
    if first is None or uniforms is None:
        if generator is None:
            raise ValueError("pass first and uniforms, or a generator")
        first = torch.randint(0, n, (), generator=generator)
        uniforms = torch.rand((k - 1,), generator=generator)
    nxt = to_device(torch.as_tensor(first).long().reshape(1), dev)
    omu = 1.0 - to_device(torch.as_tensor(uniforms, dtype=torch.float32), dev)
    xsq = (Xf * Xf).sum(-1)
    ids = torch.empty((k,), dtype=torch.int64, device=dev)

    def dist_to(row):
        c = Xf.index_select(0, row)[0]
        return torch.clamp_(torch.addmv(xsq + torch.dot(c, c), Xf, c,
                                        alpha=-2.0), min=0.0)

    ids[:1] = nxt
    d2 = dist_to(nxt)
    for i in range(1, k):
        cum = torch.cumsum(d2 / torch.clamp(d2.sum(), min=1e-30), 0)
        nxt = torch.clamp_(torch.searchsorted(cum, cum[-1:] * omu[i - 1:i]),
                           max=n - 1)
        ids[i:i + 1] = nxt
        torch.minimum(d2, dist_to(nxt), out=d2)
    return Xf[ids]


def lloyd(X, k: int, *, iters: int = 30, init: str = "kmeans++",
          generator: Optional[torch.Generator] = None,
          centroids: Optional[torch.Tensor] = None,
          force: Optional[str] = None, device: DeviceLike = None
          ) -> Tuple[torch.Tensor, torch.Tensor, List[float]]:
    """Full Lloyd iterations: (assign (n,) int32, centroids (k, d),
    per-iteration mean distortion).

    Starts from ``centroids`` when given, else from ``init`` ("kmeans++" or
    "random") drawn from ``generator``.  Assigns through
    ``kernels.ops.assign_centroids`` (the 3xTF32 kernel on the card),
    updates with two ``index_add_`` scatters and keeps empty clusters'
    centroids.  Stops early once the distortion changes by at most 1e-7 of
    itself.  One host sync per iteration: the distortion read.
    """
    dev = resolve_device(device)
    Xf = as_f32(X, dev)
    n, d = Xf.shape
    if centroids is not None:
        C = as_f32(centroids, dev)
    elif init == "kmeans++":
        C = init_kmeanspp(Xf, k, generator=generator, device=dev)
    else:
        C = init_random(Xf, k, generator=generator, device=dev)
    ones = torch.ones((n,), device=dev)
    hist: List[float] = []
    assign = None
    for _ in range(iters):
        assign, d2 = kops.assign_centroids(Xf, C, force=force)
        hist.append(float(d2.mean()))
        a = assign.long()
        D = torch.zeros((k, d), device=dev).index_add_(0, a, Xf)
        cnt = torch.zeros((k,), device=dev).index_add_(0, a, ones)
        C = torch.where((cnt > 0)[:, None],
                        D / torch.clamp(cnt, min=1.0)[:, None], C)
        if len(hist) > 2 and abs(hist[-2] - hist[-1]) <= 1e-7 * hist[-1]:
            break
    return assign, C, hist
