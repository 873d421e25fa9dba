"""Plain decode attention (``repro.models.attention.decode_attention``).

The full attention that clustered-KV decode (``core.kv_cluster``) is held
against.  The rest of the reference's attention module (the flash-style
prefill) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention over a (possibly ring-buffered) KV cache.

    q (B, 1, Hq, hd); caches (B, S, Hkv, hd); ``length`` (an int or a 0-d
    tensor): the number of valid slots.  For ``window > 0`` the cache is a
    ring buffer of size S = window and every slot written so far is valid.
    As the reference: q is scaled in float32 and rounded back to its dtype,
    scores and the weighted sum accumulate in float32 (bf16 products are
    exact in it), and the softmax weights are rounded to the values' dtype
    before that sum.  Returns (B, 1, Hq, hd) in q's dtype.
    """
    B, _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1:3]
    G = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qs = (q.float() * scale).to(q.dtype).reshape(B, Hkv, G, hd)
    scores = qs.float() @ k_cache.float().permute(0, 2, 3, 1)  # (B,Hkv,G,S)
    if window > 0:
        length = (torch.clamp(length, max=S)
                  if isinstance(length, torch.Tensor) else min(length, S))
    valid = torch.arange(S, device=q.device) < length
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype).float()
    out = p @ v_cache.float().transpose(1, 2)              # (B, Hkv, G, hd)
    return out.reshape(B, 1, Hq, hd).to(q.dtype)
