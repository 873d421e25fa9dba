"""Mixture-of-Experts layer: top-k softmax routing with capacity-based sort
dispatch (counterpart of ``repro.models.moe``).

Dispatch, as the reference's (GShard semantics, static shapes): flatten the
tokens, take each token's top-k experts, rank each (token, choice) pair
within its expert by a stable sort over expert ids, and write the token's
activations into an (E·C + 1, D) buffer; pairs ranked at or past the
capacity C go to the last row, the trash row, which is never read back.
The experts run as one batched product over (E, C, D), and the outputs are
gathered back per pair, weighted by the renormalised router probabilities
and summed per token in float32.

What is PyTorch idiom here rather than a copy:
- ``jax.lax.top_k`` breaks ties toward the lower expert; ``torch.topk``
  fixes no order among ties, so the choice is the first K of a stable
  descending sort.
- Counts are ``scatter_add_`` into fixed-size tensors: nothing here sizes a
  tensor from device data, so a decode step syncs the host zero times.
- The K pairs of a token are summed in float32 in choice order, as the
  reference's ``segment_sum`` adds them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import silu


def capacity(tokens: int, n_experts: int, top_k: int,
             factor: float = 1.25, multiple: int = 8) -> int:
    """Slots per expert: ``tokens·top_k·factor / n_experts`` plus one,
    rounded up to a multiple of ``multiple`` (a host int from static
    shapes)."""
    c = int(tokens * top_k * factor / n_experts) + 1
    return max(((c + multiple - 1) // multiple) * multiple, multiple)


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """xt (T, D), router (D, E) -> (probs (T, E), gates (T, K), expert ids
    (T, K) int64), all float32 but the ids.  Ties go to the lower expert;
    the gates are renormalised to sum to one (floored at 1e-9)."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def expert_counts(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) int64: how many (token, choice) pairs chose each expert."""
    flat = idx.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def aux_loss(probs: torch.Tensor, cnt: torch.Tensor,
             top_k: int) -> torch.Tensor:
    """The Switch load-balancing loss ``E · Σ_e mean_t(probs)_e ·
    mean_t(count of e in the token's K choices)_e / K``, float32 ()."""
    T, E = probs.shape
    me = torch.mean(probs, dim=0)
    ce = cnt.float() / T
    return E * torch.sum(me * ce) / top_k


def slots(idx: torch.Tensor, cnt: torch.Tensor, C: int):
    """Per flattened pair (T·K,): its rank within its expert (the stable
    order of expert ids), whether it fits the capacity, and its buffer row
    ``e·C + rank``, or ``E·C`` (the trash row) when dropped."""
    flat = idx.reshape(-1)
    E = cnt.shape[0]
    order = torch.argsort(flat, stable=True)
    start = torch.cumsum(cnt, 0) - cnt
    rank_sorted = torch.arange(flat.shape[0], device=flat.device) \
        - start[flat[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < C
    slot = torch.where(keep, flat * C + rank, E * C)
    return rank, keep, slot


def moe_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, router: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); expert weights (E, D, F)/(E, F, D); router (D, E).

    Returns (output (B, S, D) in x's dtype, aux load-balancing loss ()
    float32).  Expert products round to x's dtype and SiLU is the
    reference's, op for op (``layers.silu``).
    """
    B, S, D = x.shape
    E = w_gate.shape[0]
    T = B * S
    xt = x.reshape(T, D)

    probs, gate, idx = route(xt, router, top_k)
    cnt = expert_counts(idx, E)
    aux = aux_loss(probs, cnt, top_k)

    C = capacity(T, E, top_k, capacity_factor)
    _, keep, slot = slots(idx, cnt, C)
    token_of_pair = torch.arange(T * top_k, device=x.device) // top_k

    # dispatch: writes collide only in the trash row, which is discarded
    buf = x.new_zeros((E * C + 1, D))
    buf[slot] = xt[token_of_pair]
    h = buf[: E * C].view(E, C, D)

    g = silu(torch.bmm(h, w_gate))
    u = torch.bmm(h, w_up)
    out_e = torch.bmm((g * u).to(x.dtype), w_down)

    out_flat = torch.cat([out_e.reshape(E * C, D), x.new_zeros((1, D))])
    w = gate.reshape(-1) * keep.float()
    per_pair = (out_flat[slot].float() * w[:, None]).view(T, top_k, D)
    y = per_pair[:, 0]
    for k in range(1, top_k):
        y = y + per_pair[:, k]
    return y.view(B, S, D).to(x.dtype), aux
