"""Clustered-KV decode attention: the paper's insight applied to LM serving.

Counterpart of ``repro.core.kv_cluster``.  The cached keys of each (batch,
kv-head) slice are clustered with the equal-size 2M tree (paper Alg. 1),
optionally polished by dense engine epochs; a decode query then attends
only to the members of the top-c clusters, ranked by the ball bound
``q·c + ‖q‖·r`` — O(c·cap) attended keys instead of O(S).

The reference vmaps the tree and the engine over the B·Hkv slices; here
both take all slices in one call (``two_means_tree`` on (P, n, d),
``engine.run_slices``), so a build launches as many kernels as one slice's
would.  The member tables come from ``members_table_local`` over flat ids
``s·kc + cluster`` with slice-local positions.  Everything is plain
PyTorch — the reference computes it in XLA outside any Pallas kernel — and
neither a build nor an attention call syncs the host.

Differences from the reference, all stated: the draws are injectable (the
tree's seed offsets and the epoch words per slice), else drawn from a CPU
``torch.Generator``; ``torch.topk`` does not fix the order of tied bounds
(ties arise among empty clusters, radius ``-inf``, whose table rows are all
-1, so the outputs do not depend on it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device, to_device
from repro_torch.core import engine
from repro_torch.core.knn_graph import members_table_local
from repro_torch.core.two_means import two_means_tree

NEG_INF = -1e30      # the mask value: a fully masked head averages uniformly


class KVClusters(NamedTuple):
    centroids: torch.Tensor  # (B, Hkv, kc, hd) float32
    table: torch.Tensor      # (B, Hkv, kc, cap) int32 member ids, -1 padded
    radii: torch.Tensor      # (B, Hkv, kc) float32 max ||k - centroid||


def _select_clusters(qs: torch.Tensor, clusters: KVClusters, top_c: int
                     ) -> torch.Tensor:
    """Top-c clusters per q head by the ball upper bound on member scores:
    q·k = q·c + q·(k−c) <= q·c + ‖q‖·r (Cauchy–Schwarz).  qs (B, Hkv, G,
    hd) -> (B, Hkv, G, c) cluster ids."""
    cscore = qs @ clusters.centroids.mT                    # (B, Hkv, G, kc)
    bound = cscore + (torch.linalg.vector_norm(qs, dim=-1)[..., None]
                      * clusters.radii[:, :, None, :])
    return torch.topk(bound, top_c, dim=-1).indices


def _candidates(top: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The member ids of each q head's selected clusters: (B, Hkv, G, c·cap)."""
    B, Hkv, G, _ = top.shape
    bidx = torch.arange(B, device=top.device)[:, None, None, None]
    hidx = torch.arange(Hkv, device=top.device)[None, :, None, None]
    return table[bidx, hidx, top].reshape(B, Hkv, G, -1)


def _centroids_radii(rows: torch.Tensor, a: torch.Tensor, k: int):
    """Per-cluster means and radii (max ||row − centroid||) of ``rows``
    (n, d) f32 under ids ``a`` (n,) in [0, k).  An empty cluster has
    centroid 0 and radius -inf, as the reference's ``segment_max``."""
    dev = rows.device
    D = torch.zeros((k, rows.shape[1]), device=dev).index_add_(0, a, rows)
    n = torch.zeros((k,), device=dev).index_add_(
        0, a, torch.ones((rows.shape[0],), device=dev))
    cent = D / torch.clamp(n, min=1.0)[:, None]
    r = torch.linalg.vector_norm(rows - cent[a], dim=-1)
    radii = torch.full((k,), float("-inf"), device=dev).scatter_reduce_(
        0, a, r, reduce="amax")
    return cent, radii


def build_kv_clusters(keys, kc: int, *, cap_factor: int = 2,
                      refine_epochs: int = 0, refine_mode: str = "bkm",
                      tree_seeds=None, epoch_words=None,
                      generator: Optional[torch.Generator] = None,
                      device: DeviceLike = None) -> KVClusters:
    """Cluster cached keys per (batch, kv-head).

    keys (B, S, Hkv, hd), any float dtype; kc a power of two dividing S.
    Runs on ``device`` (default ``cuda``; pass ``device="cpu"`` for the
    CPU).  ``refine_epochs > 0`` polishes the equal-size partition with
    dense engine epochs (``min_move_frac=-1``: every epoch runs), which
    makes the sizes unequal; a cluster past ``cap = cap_factor·S/kc``
    loses its overflow members from the table.

    Draws: ``tree_seeds`` = (i1, i2), each (B·Hkv, log2 kc, kc), the tree's
    per-slice seed offsets; ``epoch_words`` (B·Hkv, refine_epochs, 4) the
    engine's per-slice subkey words (the reference's ``keys_r[i]`` seeds
    both: ``jax.random.bits(fold_in(keys_r[i], t), (4,))``); what is not
    given is drawn from ``generator`` (a CPU ``torch.Generator``).
    """
    dev = resolve_device(device)
    keys = to_device(torch.as_tensor(keys), dev)
    B, S, H, hd = keys.shape
    P = B * H
    cap = cap_factor * (S // kc)
    flat = keys.permute(0, 2, 1, 3).reshape(P, S, hd).float()
    assign = two_means_tree(flat, kc, seeds=tree_seeds, generator=generator,
                            refine_iters=2)                     # (P, S)
    if refine_epochs:
        cfg = engine.EngineConfig(batch_size=min(1024, S), mode=refine_mode,
                                  iters=refine_epochs, min_move_frac=-1.0)
        assign = engine.run_slices(flat, assign, kc, cfg,
                                   epoch_words=epoch_words,
                                   generator=generator).assign
    rows = flat.reshape(P * S, hd)
    a = (assign.long()
         + torch.arange(P, device=dev)[:, None] * kc).reshape(-1)
    cent, radii = _centroids_radii(rows, a, P * kc)
    pos = torch.arange(S, device=dev).repeat(P)
    table_T, _, _ = members_table_local(a, pos, P * kc, cap, 0)
    return KVClusters(cent.view(B, H, kc, hd),
                      table_T.T.reshape(B, H, kc, cap),
                      radii.view(B, H, kc))


def clustered_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, clusters: KVClusters,
                               length, *, top_c: int = 4) -> torch.Tensor:
    """q (B, 1, Hq, hd); caches (B, S, Hkv, hd) -> (B, 1, Hq, hd) in q's
    dtype, on the inputs' device.

    Each q head (h = kvh·G + g) attends only to the members of its top_c
    clusters whose ids are below ``length`` (an int or a 0-d tensor, which
    is compared on the device: no host sync).
    """
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qs = (q.float() * hd ** -0.5).reshape(B, Hkv, G, hd)
    cand = _candidates(_select_clusters(qs, clusters, top_c), clusters.table)
    valid = (cand >= 0) & (cand < length)
    cand_safe = torch.clamp(cand, min=0)
    bidx = torch.arange(B, device=q.device)[:, None, None, None]
    hidx = torch.arange(Hkv, device=q.device)[None, :, None, None]
    kg = k_cache[bidx, cand_safe, hidx].float()          # (B, Hkv, G, T, hd)
    vg = v_cache[bidx, cand_safe, hidx].float()
    scores = (kg @ qs[..., None])[..., 0]
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = (p[..., None, :] @ vg)[..., 0, :]
    return out.reshape(B, 1, Hq, hd).to(q.dtype)


def candidate_recall(q: torch.Tensor, k_cache: torch.Tensor,
                     clusters: KVClusters, length, top_c: int
                     ) -> torch.Tensor:
    """Diagnostic: the fraction of (batch, q head) whose true max-score key
    (q unscaled, as the reference) lies in the selected candidates; a 0-d
    float32 tensor on the inputs' device."""
    B, _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1:3]
    G = Hq // Hkv
    qs = q.float().reshape(B, Hkv, G, hd)
    full = qs @ k_cache.float().permute(0, 2, 3, 1)       # (B, Hkv, G, S)
    pos = torch.arange(S, device=q.device)
    full = torch.where(pos < length, full, NEG_INF)
    best = full.argmax(dim=-1)                            # first maximum
    cand = _candidates(_select_clusters(qs, clusters, top_c), clusters.table)
    hit = (cand == best[..., None]).any(dim=-1)
    return hit.float().mean()
