"""O(n) sort-free epoch shuffle (``repro.core.permute``), bit-exact.

A Feistel-network permutation of ``[0, M)``, ``M = 2**ceil(log2 n)``, with
cycle-walking back into ``[0, n)`` — the same construction, rounds and
murmur3 fmix32 round function as the reference.  Given the same four 32-bit
subkey words (the reference draws them as ``jax.random.bits(key, (4,))``)
the order is identical.  torch has little uint32 arithmetic, so the words
are carried in int64 and masked to 32 bits after every step; products are
split into 16-bit halves so no intermediate leaves int64's range.

The order is computed on the CPU and copied to the target device through
pinned memory without blocking: the cycle walk's loop test reads its own
CPU tensor, so an epoch order costs the device no host sync.
``epoch_orders`` makes one order per row of words in one pass (the engine's
slice-batched run).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch._device import to_device

ROUNDS = 4
MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35

Words = Union[torch.Tensor, Sequence[int]]


def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant m."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64-held uint32 values."""
    h = h ^ (h >> 16)
    h = mul32(h, _M1)
    h = h ^ (h >> 13)
    h = mul32(h, _M2)
    return h ^ (h >> 16)


def draw_words(generator: torch.Generator, count: int = ROUNDS) -> torch.Tensor:
    """``count`` uniform uint32 words as int64 (CPU), from ``generator``."""
    return torch.randint(0, 1 << 32, (count,), generator=generator,
                         dtype=torch.int64, device="cpu")


def random_rows(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """The first k of a random permutation of ``arange(n)`` (CPU int64),
    drawn from ``generator`` (a CPU ``torch.Generator``): random distinct
    rows, as a baseline's random init takes them."""
    return torch.randperm(n, generator=generator)[:k]


def _subkeys(words) -> torch.Tensor:
    """(P, ROUNDS) uint32 subkey words as an int64 CPU tensor, from one
    row of words or a (P, ROUNDS) array of them."""
    # lint: boundary(the words are host values: a CPU tensor at most)
    rows = words.tolist() if isinstance(words, torch.Tensor) else words
    # lint: boundary(host words, read one by one)
    rows = [[int(w) & MASK32 for w in r] for r in rows]
    sub = torch.tensor(rows, dtype=torch.int64).reshape(len(rows), -1)
    if sub.shape[1] != ROUNDS:
        raise ValueError(f"need {ROUNDS} subkey words, got {sub.shape[1]}")
    return sub


def epoch_orders(words, n: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """One pseudorandom permutation of ``arange(n)`` per row of ``words``
    ((P, ROUNDS) uint32 values), as (P, n) int64 on device.  Row p equals
    ``epoch_order(words[p], n)``.  Rows are permuted a block at a time, a
    block of about 2**18 values, so the temporaries stay in cache."""
    device = torch.device("cpu") if device is None else torch.device(device)
    sub = _subkeys(words)
    P = sub.shape[0]
    if n <= 1:
        return torch.zeros((P, n), dtype=torch.int64, device=device)
    bits = max(1, (n - 1).bit_length())

    def prp(x: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
        lo_b, hi_b = bits // 2, bits - bits // 2
        for r in range(ROUNDS):
            lo = x & ((1 << lo_b) - 1)
            hi = x >> lo_b
            f = mix32(lo ^ sub[:, r:r + 1]) & ((1 << hi_b) - 1)
            x = (lo << hi_b) | (hi ^ f)
            lo_b, hi_b = hi_b, lo_b
        return x

    out = torch.empty((P, n), dtype=torch.int64)
    step = max(1, (1 << 18) // n)
    for p0 in range(0, P, step):
        blk = sub[p0:p0 + step]
        x = prp(torch.arange(n, dtype=torch.int64).expand(len(blk), n), blk)
        walk = x >= n
        # lint: boundary(a CPU tensor: no device sync)
        while bool(walk.any()):
            x = torch.where(walk, prp(x, blk), x)
            walk = x >= n
        out[p0:p0 + step] = x
    return to_device(out, device)


def epoch_order(words: Words, n: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """A pseudorandom permutation of ``arange(n)`` as (n,) int64 on device.

    ``words`` are the ROUNDS subkey words (uint32 values).
    """
    return epoch_orders([words], n, device)[0]
