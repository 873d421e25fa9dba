"""Host-sync accounting (counterpart of ``repro.obs.syncs``).

Every "exactly N host syncs" claim of the port is checked the same way:
run the code under ``sync_counter()``, where CUDA's sync-debug mode is
``"error"`` (the counterpart of the reference's
``transfer_guard_device_to_host("disallow")``), so a stray device-to-host
copy or ``.item()`` raises, and make each intended read through ``sc.get``
or the module's ``read``, which lift the mode for that one copy and count
it.

    with sync_counter() as sc:
        r = gk_means(X, k, ...)         # stray syncs raise here
    assert sc.syncs == r.host_syncs     # epochs + 1

The port's reads by design (one per engine epoch in ``core.engine.run``,
``gk_means``'s final distortion) go through ``read``: it counts into the
innermost active counter, and is a plain read when none is active.  On the
CPU sync-debug mode sees nothing, and only the counted reads count.
``torch.cuda.synchronize()`` is not a sync that sync-debug mode reports
(the ``span`` timers use it); ``sc.block`` counts one explicitly.

The stack of active counters is module state, as ``_build.launch_counts``
is: counters nest, and only the innermost one counts a read.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Set

import torch

_active: List["SyncCounter"] = []


def _cuda() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def _debug_mode(mode) -> Iterator[None]:
    """Sync-debug mode set to ``mode`` inside the block (a no-op without
    CUDA), restored after."""
    if not _cuda():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _to_host(tree: Any) -> Any:
    """Every tensor of a (nested) tuple, list or dict copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _storages(tree: Any) -> List[int]:
    """Storage ids of every tensor of a (nested) tuple, list or dict."""
    if isinstance(tree, torch.Tensor):
        return [tree.untyped_storage()._cdata]
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in _storages(v)]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _storages(v)]
    return []


class SyncCounter:
    """Counts explicit host syncs performed through it (see module doc)."""

    def __init__(self) -> None:
        self.syncs = 0
        self.host: Set[int] = set()   # storages of the reads' host copies

    def get(self, tree: Any) -> Any:
        """The tree's tensors copied to the CPU with sync-debug mode lifted
        for the copy; counts one sync."""
        with _debug_mode(0):
            out = _to_host(tree)
        self.syncs += 1
        self.host.update(_storages(out))
        return out

    def block(self, tree: Any = None) -> Any:
        """``torch.cuda.synchronize()`` (when there is CUDA); counts one.
        Returns ``tree``."""
        if _cuda():
            with _debug_mode(0):
                torch.cuda.synchronize()
        self.syncs += 1
        return tree


@contextlib.contextmanager
def sync_counter() -> Iterator[SyncCounter]:
    """Sync-debug mode ``"error"`` inside the block; yields a
    ``SyncCounter``.

    Implicit syncs inside the block raise; intended ones go through
    ``sc.get``/``sc.block`` or ``read`` and are tallied in ``sc.syncs``.
    """
    sc = SyncCounter()
    _active.append(sc)
    try:
        with _debug_mode("error"):
            yield sc
    finally:
        _active.remove(sc)


def host_storages() -> Set[int]:
    """Storages of the host copies the active counters' reads returned (a
    conversion of one of them to a Python number reads the host, not the
    device: the contract audit tells such reads from stray ones)."""
    return set().union(*(sc.host for sc in _active))


def read(tree: Any) -> Any:
    """A designed host read: the tree's tensors copied to the CPU, counted
    by the innermost active ``sync_counter`` (a plain copy when none is
    active)."""
    if _active:
        return _active[-1].get(tree)
    return _to_host(tree)
