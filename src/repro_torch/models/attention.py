"""GQA attention: the chunked (flash-style) prefill path and the decode
path (counterpart of ``repro.models.attention``).

``flash_attention`` streams KV blocks with an online-softmax carry, so the
(S, S) score matrix is never materialised, with the reference's masks,
chunking, irregular-size fallback and ``causal_skip`` schedule.  The
reference has no kernel here (plain ``jnp``), and neither has the port:
plain PyTorch ops.  ``decode_attention`` is also the full attention that
clustered-KV decode (``core.kv_cluster``) is held against.

Precision is the reference's: q is scaled in float32 and rounded back to
its dtype; scores, softmax statistics and the weighted sums are float32
(bf16 inputs are upcast, so each product is exact and only the sum order
differs); the softmax weights are rounded to the values' dtype before the
second product.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _block_attn(q, k, v, qpos, kpos, causal: bool, window: int):
    """q: (B, Sq, Hkv, G, hd); k/v: (B, Skv, Hkv, hd) -> partial softmax
    stats (m, l, acc): running max (B, Sq, Hkv, G), denominator, weighted
    values (B, Sq, Hkv, G, hd), all float32."""
    scores = torch.einsum("bqhgd,bkhd->bqhgk", q.float(), k.float())
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = torch.where(mask[None, :, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    e = torch.where(torch.isfinite(m)[..., None], e, 0.0)
    l = e.sum(dim=-1)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", e.to(v.dtype).float(), v.float())
    return m, l, acc


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_chunk: int = 1024, q_chunk: int = 2048,
                    scale: Optional[float] = None,
                    causal_skip: bool = False) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd) in
    q's dtype.

    ``q_offset``: absolute position of q[0] (prefill continuation).  When
    ``kv_chunk`` or ``q_chunk`` does not divide its length, one block
    covers everything (the reference's irregular-size fallback).
    ``causal_skip``: at ``q_offset == 0``, ``Sq == Skv`` and no window, q
    chunk i scans only the causally visible kv blocks ``[0, hi_i)`` (the
    reference's triangular schedule).
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1:3]
    G = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qs = (q.float() * scale).to(q.dtype).reshape(B, Sq, Hkv, G, hd)
    dev = q.device

    kv_chunk = min(kv_chunk, Skv)
    q_chunk = min(q_chunk, Sq)
    if Skv % kv_chunk or Sq % q_chunk:
        m, l, acc = _block_attn(qs, k, v,
                                torch.arange(Sq, device=dev) + q_offset,
                                torch.arange(Skv, device=dev), causal, window)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.reshape(B, Sq, Hq, hd).to(q.dtype)

    nkv = Skv // kv_chunk

    def q_block(qb, qpos, hi):
        """One q chunk against kv blocks [0, hi), merged online."""
        m = torch.full(qb.shape[:4], NEG_INF, device=dev)
        l = torch.zeros(qb.shape[:4], device=dev)
        acc = torch.zeros(qb.shape, device=dev)
        for j in range(hi):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            m1, l1, acc1 = _block_attn(qb, k[:, sl], v[:, sl], qpos,
                                       torch.arange(sl.start, sl.stop,
                                                    device=dev),
                                       causal, window)
            mn = torch.maximum(m, m1)
            a0 = torch.exp(m - mn)
            a1 = torch.exp(m1 - mn)
            m, l = mn, l * a0 + l1 * a1
            acc = acc * a0[..., None] + acc1 * a1[..., None]
        return acc / torch.clamp(l, min=1e-30)[..., None]

    skip = causal_skip and causal and q_offset == 0 and Sq == Skv \
        and not window
    outs = []
    for i in range(Sq // q_chunk):
        hi = (min(((i + 1) * q_chunk + kv_chunk - 1) // kv_chunk, nkv)
              if skip else nkv)
        sl = slice(i * q_chunk, (i + 1) * q_chunk)
        outs.append(q_block(qs[:, sl], torch.arange(sl.start, sl.stop,
                                                    device=dev) + q_offset,
                            hi))
    out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


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
