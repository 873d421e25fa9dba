"""Host-side span timer (counterpart of ``repro.obs.timing.span``).

``span`` times a block on the host clock and, when given a CUDA device,
synchronises that device at both ends, so the seconds cover the device work
the block enqueued rather than just its launch.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def span(name: str, out: Dict[str, float],
         device: Optional[torch.device] = None) -> Iterator[None]:
    """``with span("graph", secs, dev): ...`` sets ``secs["graph"]``."""
    sync = device is not None and torch.device(device).type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(device)
    out[name] = time.perf_counter() - t0
