"""Serving steps: prefill (prompt -> cache) and decode (one token a step).

Counterpart of ``repro.train.serve_step``.  The port's ``Model`` carries
its weights, so a step closes over the model where the reference's takes
``params``; the reference jits each step, the port runs it eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.model import Cache, Model


def make_prefill(model: Model, cache_len: int) -> Callable:
    """``prefill(batch) -> (last logits (B, V), cache)``."""

    def prefill(batch: Dict[str, torch.Tensor]):
        return model.prefill(batch, cache_len)

    return prefill


def make_decode_step(model: Model, sample: bool = False) -> Callable:
    """``decode_step(tokens (B, 1), cache, generator=None) -> (next tokens
    (B, 1) int32, logits (B, V), cache)``: greedy (argmax), or with
    ``sample`` and a generator a draw from the softmax of the logits."""

    def decode_step(tokens: torch.Tensor, cache: Cache,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
        logits, cache = model.decode_step(tokens, cache)
        if sample and generator is not None:
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None].to(torch.int32), logits, cache

    return decode_step
