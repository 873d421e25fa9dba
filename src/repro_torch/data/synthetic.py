"""Synthetic stand-ins for SIFT/GloVe/GIST and LM token batches
(counterpart of ``repro.data.synthetic``), drawn from an explicit
``torch.Generator``.

The data lands on the generator's device, so a CUDA generator makes a
SIFT1M-sized set on the card in one pass.
"""
from __future__ import annotations

import torch


def gmm_blobs(n: int, d: int, components: int, *,
              generator: torch.Generator, spread: float = 4.0
              ) -> torch.Tensor:
    """n samples from ``components`` Gaussians with random means/scales."""
    g, dev = generator, generator.device
    means = torch.randn((components, d), generator=g, device=dev) * spread
    scales = torch.exp(torch.randn((components, 1), generator=g,
                                   device=dev) * 0.3)
    comp = torch.randint(0, components, (n,), generator=g, device=dev)
    noise = torch.randn((n, d), generator=g, device=dev)
    return (means[comp] + noise * scales[comp]).float()


def sift_like(n: int, d: int, components: int, *,
              generator: torch.Generator) -> torch.Tensor:
    """Non-negative heavy-tailed vectors (SIFT-histogram-like)."""
    return gmm_blobs(n, d, components, generator=generator).abs() ** 1.5


def token_batch(batch: int, seq: int, vocab: int, *,
                generator: torch.Generator) -> dict:
    """A token batch for LM training: ``(batch, seq + 1)`` int32 tokens in
    ``[0, vocab)`` on the generator's device, as ``tokens`` (all but the
    last) and ``labels`` (all but the first)."""
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=generator,
                         device=generator.device, dtype=torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
