"""Timers and kernel scopes (counterpart of ``repro.obs.timing``).

``span`` times a block on the host clock and, when given a CUDA device,
synchronises that device at both ends, so the seconds cover the device work
the block enqueued rather than just its launch.  ``device_span`` is its
device-time counterpart: CUDA events on the current stream around the
block, read after the end event completes.

``kernel_scope(name)`` names a kernel launch ``repro_torch.kernels.<name>``
in a ``torch.profiler`` trace (a ``record_function`` range) and in an NVTX
timeline.  ``kernels/_build.py::launch`` enters it around every launch, so
all eight kernels are named in one place.  With no profiler running it is a
shared null context: the check is one attribute read, so the engine's
thousands of launches an epoch pay nothing for it.  ``scope_coverage``
reads a trace back: how many ranges it holds, and whether each device
launch of the named kernels was made inside one.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterable, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SCOPE_PREFIX = "repro_torch.kernels"
_NULL = contextlib.nullcontext()


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


@contextlib.contextmanager
def device_span(name: str, out: Dict[str, float]) -> Iterator[None]:
    """``with device_span("scan", ms): ...`` sets ``ms["scan"]`` to the
    device milliseconds between two CUDA events recorded on the current
    stream before and after the block (waits for the second)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    end.synchronize()
    out[name] = start.elapsed_time(end)


@contextlib.contextmanager
def _named_range(label: str) -> Iterator[None]:
    with torch.profiler.record_function(label):
        nvtx = torch.cuda.is_available()
        if nvtx:
            torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def kernel_scope(name: str):
    """A ``repro_torch.kernels.<name>`` profiler and NVTX range while a
    profiler runs; a null context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _named_range(f"{SCOPE_PREFIX}.{name}")


def scope_coverage(events: Iterable, markers: Iterable[str]
                   ) -> Dict[str, Any]:
    """Read a ``torch.profiler`` trace (``prof.events()``) for the kernel
    scopes.  ``ranges``: the CPU ranges per ``repro_torch.kernels.<name>``;
    ``range_launches``: per name, the kernel-launch calls of the CUDA
    runtime made inside such a range; ``device_launches``: the device
    kernels whose name holds one of ``markers``; ``in_range``: how many of
    those were launched (the runtime call with the kernel's correlation id)
    inside a range.  A trace may lose device records, never the host's, so
    ``range_launches`` counts every launch and ``device_launches`` those
    the trace kept."""
    cpu = torch.autograd.DeviceType.CPU
    prefix = SCOPE_PREFIX + "."
    events = list(events)

    def scope(ev):
        parent = getattr(ev, "cpu_parent", None)
        while parent is not None and not parent.name.startswith(prefix):
            parent = parent.cpu_parent
        return None if parent is None else parent.name[len(prefix):]
    ranges: Dict[str, int] = {}
    range_launches: Dict[str, int] = {}
    runtime = {}
    for ev in events:
        if ev.device_type != cpu:
            continue
        if ev.name.startswith(prefix):
            name = ev.name[len(prefix):]
            ranges[name] = ranges.get(name, 0) + 1
        elif ev.name.startswith("cu"):          # CUDA runtime/driver calls
            runtime[ev.id] = ev
            name = scope(ev) if "LaunchKernel" in ev.name else None
            if name is not None:
                range_launches[name] = range_launches.get(name, 0) + 1
    markers = tuple(markers)
    launches = covered = 0
    for ev in events:
        if (ev.device_type == cpu or ev.name.startswith(prefix)
                or not any(m in ev.name for m in markers)):
            continue
        launches += 1
        rt = runtime.get(ev.id)
        covered += rt is not None and scope(rt) is not None
    return {"ranges": ranges, "range_launches": range_launches,
            "device_launches": launches, "in_range": covered}
