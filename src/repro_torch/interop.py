"""Carry the JAX package's state, given as numpy arrays, into the port.

The clustering system's counterpart of carrying weights across: one
reference graph, one initial state and one set of epoch keys can be fed to
both packages, so their outputs compare like with like.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import BKMState
from repro_torch.core.knn_graph import KnnGraph


def _tensor(a, dtype, device) -> torch.Tensor:
    """An owned, contiguous copy of array ``a`` (arrays handed over from
    JAX are read-only)."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def knn_graph(ids, dist, device="cpu") -> KnnGraph:
    """KnnGraph from (n, κ) neighbour ids and squared distances."""
    return KnnGraph(_tensor(ids, np.int32, device),
                    _tensor(dist, np.float32, device))


def bkm_state(assign, D, cnt, device="cpu") -> BKMState:
    """BKMState from an (n,) assignment, (k, d) composites, (k,) counts."""
    return BKMState(_tensor(assign, np.int32, device),
                    _tensor(D, np.float32, device),
                    _tensor(cnt, np.float32, device),
                    torch.zeros((), dtype=torch.int32, device=device))


def epoch_words(words) -> torch.Tensor:
    """(epochs, 4) uint32 subkey words (e.g. ``jax.random.bits(key, (4,))``
    per epoch) as the int64 CPU tensor ``engine.run(epoch_words=...)``
    takes."""
    return _tensor(np.asarray(words, dtype=np.uint64).reshape(-1, 4),
                   np.int64, "cpu")
