"""RG-LRU (Real-Gated Linear Recurrent Unit), RecurrentGemma / Griffin's
recurrent block (counterpart of ``repro.models.rglru``).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),   c = 8.

Prefill runs the linear recurrence as a parallel prefix scan over the
sequence; decode is one recurrence step.  The gates and the recurrence
are float32; the output is cast to x's dtype.

What is PyTorch idiom here rather than a copy: PyTorch has no
``lax.associative_scan``, so ``_assoc_scan`` spells out its recursion (the
one in JAX's ``lax/control_flow/loops.py``): combine adjacent pairs,
scan the half-length sequence, combine each odd result with the next
even input, interleave.  The combines happen in JAX's order, so float32
results agree within a few ulps (an FMA here or there), in about
2·log2(S) levels of strided elementwise ops rather than S steps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import softplus

_C = 8.0

Pair = Tuple[torch.Tensor, torch.Tensor]


def _gates(x: torch.Tensor, lam: torch.Tensor, w_r: torch.Tensor,
           b_r: torch.Tensor, w_i: torch.Tensor, b_i: torch.Tensor) -> Pair:
    """x: (B, S, W) -> (a, gated input), both float32.  The gate products
    are rounded to x's dtype before the float32 bias, as the reference's
    einsums are."""
    r = torch.sigmoid((x @ w_r).float() + b_r.float())
    i = torch.sigmoid((x @ w_i).float() + b_i.float())
    log_a = -_C * softplus(lam.float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    return a, mult * i * x.float()


def _combine(c1: Pair, c2: Pair) -> Pair:
    """(a1, b1) then (a2, b2): h -> a2·(a1·h + b1) + b2."""
    (a1, b1), (a2, b2) = c1, c2
    return a1 * a2, a2 * b1 + b2


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Inclusive scan of ``_combine`` over dim 1 of (B, S, W) tensors."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _assoc_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                         (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ev_a, ev_b = _combine((odd_a[:, :-1], odd_b[:, :-1]),
                              (a[:, 2::2], b[:, 2::2]))
    else:
        ev_a, ev_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, ev, odd in ((a, ev_a, odd_a), (b, ev_b, odd_b)):
        t = torch.empty_like(first)
        t[:, :1] = first[:, :1]
        t[:, 2::2] = ev
        t[:, 1::2] = odd
        out.append(t)
    return out[0], out[1]


def rglru_scan(x: torch.Tensor, lam: torch.Tensor, w_r: torch.Tensor,
               b_r: torch.Tensor, w_i: torch.Tensor, b_i: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> Pair:
    """x: (B, S, W) -> (y (B, S, W) in x's dtype, final hidden (B, W)
    float32)."""
    a, bx = _gates(x, lam, w_r, b_r, w_i, b_i)
    if h0 is not None:
        # the carried state folds in as a virtual step: b_0 += a_0 * h0
        bx[:, 0] += a[:, 0] * h0.float()
    _, hh = _assoc_scan(a, bx)
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(x: torch.Tensor, h: torch.Tensor, lam: torch.Tensor,
               w_r: torch.Tensor, b_r: torch.Tensor, w_i: torch.Tensor,
               b_i: torch.Tensor) -> Pair:
    """x: (B, W), h: (B, W) -> (y in x's dtype, new h float32)."""
    a, bx = _gates(x[:, None, :], lam, w_r, b_r, w_i, b_i)
    new = a[:, 0] * h.float() + bx[:, 0]
    return new.to(x.dtype), new
