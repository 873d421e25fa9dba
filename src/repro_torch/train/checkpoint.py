"""Fault-tolerant checkpoints (counterpart of ``repro.train.checkpoint``),
on the reference's on-disk protocol and layout, so that either package
reads a file the other wrote when the trees match.

A checkpoint of step ``s`` is the directory ``step_{s:010d}`` holding
``shard_00000.npz`` (one array a leaf, keyed by the leaf's path: dict keys
and sequence indices joined by ``/``, written ``__`` inside the npz;
bfloat16 stored as its uint16 bit pattern) and ``manifest.json``
(``step``, ``extra`` and each leaf's logical ``shape`` and ``dtype`` name,
``"bfloat16"`` for bf16).  Both files are written into a ``.tmp_*``
directory and fsync'd, the directory is renamed into place, and the
``latest`` pointer is replaced last: a crash mid-write never leaves a
partial checkpoint visible, and the previous one stays whole.  ``keep``
checkpoints are retained for rollback.

What is PyTorch idiom here rather than a copy: a tree is nested dicts,
tuples and lists whose leaves are tensors on any device, numpy arrays or
Python scalars, and a card tensor is copied to the host once (a counted
host read each, ``obs.syncs.read``).  ``restore`` returns tensors, each on
``device`` or else on the device of the matching leaf of ``like`` (the CPU
where that leaf is no tensor), and reads bf16 back from its bits without
``ml_dtypes``.  The port trains on one device, so one process writes the
one shard.

Throughput, the format unchanged: a save copies the next tensor to the
host in a worker thread while it writes the previous one into the npz
(the zip writer of ``np.savez``), and a thread writes the file's dirty
pages back to disk meanwhile (``_flush_behind``), so the final fsync waits
only for the tail; a restore reads the stored members straight from the
file in parallel threads, each checking the member's CRC-32 as
``zipfile`` would (``_read_member``).
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import struct
import tempfile
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.obs.syncs import read

Tree = Any


def _items(tree: Tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of every leaf, in the order of the tree's containers."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree: Tree) -> Dict[str, Any]:
    """{path joined by "/": leaf}, the reference's keys."""
    return {"/".join(p): leaf for p, leaf in _items(tree)}


def _unflatten(like: Tree, leaves: Dict[str, Any], prefix=()) -> Tree:
    """``like``'s structure with each leaf taken from ``leaves`` by path."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor copied in one counted host
    read); bf16, as a torch tensor or as numpy's ``ml_dtypes`` array, as
    its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = read(leaf.detach())
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _host_arrays(flat: Dict[str, Any]) -> Iterator[Tuple[str, np.ndarray]]:
    """(npz key, ``_host_array``) of each leaf in order, the copies made by
    a worker thread ahead of the caller, who writes the previous array
    meanwhile."""
    with ThreadPoolExecutor(1) as pool:
        futures = [(k, pool.submit(_host_array, v)) for k, v in flat.items()]
        try:
            for k, fut in futures:
                yield k.replace("/", "__"), fut.result()
        finally:
            for _, fut in futures:
                fut.cancel()


def _write_npz(f, arrays) -> None:
    """``np.savez``'s zip writer: one stored ``{key}.npy`` member an array,
    zip64 forced, in the order given."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, a in arrays:
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array(fid, a, allow_pickle=False)


@contextlib.contextmanager
def _flush_behind(f):
    """Inside the block a thread fsyncs ``f``'s descriptor over and over,
    so the disk writes back what the block has written while it writes
    more; an error of those fsyncs is raised at the end (a later fsync
    may not report it again)."""
    done, errors = threading.Event(), []

    def loop():
        try:
            while not done.wait(0.2):
                os.fsync(f.fileno())
        except OSError as e:
            errors.append(e)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        yield
    finally:
        done.set()
        th.join()
    if errors:
        raise errors[0]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _fsync(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree: Tree, *,
         extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically write checkpoint ``step`` of ``tree``; keeps the newest
    ``keep``.  Returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_{step}_")

    flat = _flatten(tree)
    manifest = {"step": step, "extra": extra or {},
                "leaves": {k: {"shape": list(np.shape(v)),
                               "dtype": _dtype_name(v)}
                           for k, v in flat.items()}}
    with open(os.path.join(tmp, "shard_00000.npz"), "wb") as f:
        with _flush_behind(f):
            _write_npz(f, _host_arrays(flat))
        _fsync(f)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        _fsync(f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                  # atomic publish
    ptr_tmp = os.path.join(ckpt_dir, ".latest.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
        _fsync(f)
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "latest"))

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step the ``latest`` pointer names, or None (no pointer, or its
    directory is gone).  A ``.tmp_*`` directory is never a checkpoint."""
    ptr = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


_LOCAL_HEADER = struct.Struct("<4s5H3I2H")   # a zip member's local header
_READERS = 8


def _read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One stored ``.npy`` member of the npz at ``path``, read straight
    from the file into a new array; its CRC-32 checked as ``zipfile``
    checks it."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{path}: {info.filename} is compressed")
    fmt = np.lib.format
    with open(path, "rb") as fh:
        fh.seek(info.header_offset)
        head = _LOCAL_HEADER.unpack(fh.read(_LOCAL_HEADER.size))
        if head[0] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"{path}: bad header of "
                                     f"{info.filename}")
        start = fh.seek(head[-2] + head[-1], os.SEEK_CUR)
        version = fmt.read_magic(fh)
        if version == (1, 0):
            shape, fortran, dtype = fmt.read_array_header_1_0(fh)
        elif version == (2, 0):
            shape, fortran, dtype = fmt.read_array_header_2_0(fh)
        else:
            raise ValueError(f"{path}: {info.filename} is npy {version}")
        if dtype.hasobject:
            raise ValueError(f"{path}: {info.filename} holds objects")
        header = fh.tell() - start
        raw = np.empty(int(np.prod(shape)) * dtype.itemsize, np.uint8)
        if fh.readinto(memoryview(raw)) != raw.size or \
                header + raw.size != info.file_size:
            raise zipfile.BadZipFile(f"{path}: {info.filename} is short")
        fh.seek(start)
        crc = zlib.crc32(raw, zlib.crc32(fh.read(header)))
    if crc != info.CRC:
        raise zipfile.BadZipFile(f"{path}: bad CRC-32 for {info.filename}")
    return raw.view(dtype).reshape(shape, order="F" if fortran else "C")


def _read_shards(path: str) -> Dict[str, np.ndarray]:
    """Every array of a checkpoint's shards, keyed by leaf path, the
    members read by ``_READERS`` threads, the largest first."""
    jobs = []
    for s in sorted(p for p in os.listdir(path) if p.startswith("shard_")):
        with zipfile.ZipFile(os.path.join(path, s)) as z:
            jobs += [(os.path.join(path, s), i) for i in z.infolist()]
    jobs.sort(key=lambda j: -j[1].file_size)
    with ThreadPoolExecutor(_READERS) as pool:
        arrays = pool.map(lambda j: _read_member(*j), jobs)
        return {info.filename[:-len(".npy")].replace("__", "/"): a
                for (_, info), a in zip(jobs, arrays)}


def restore(ckpt_dir: str, like: Tree, *, step: Optional[int] = None,
            device: DeviceLike = None) -> Tuple[Tree, int, dict]:
    """(tree, step, extra) of checkpoint ``step`` (default: the latest),
    the tree in the structure of ``like`` with each leaf a tensor in the
    manifest's dtype, on ``device`` or else on the device of ``like``'s
    matching leaf (the CPU where that leaf is no tensor).

    Raises ``FileNotFoundError`` without a checkpoint, ``KeyError`` for a
    leaf of ``like`` the checkpoint lacks, and ``ValueError`` where the
    stored shape, the manifest's shape and ``like``'s shape disagree."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = _read_shards(path)

    out = {}
    for k, ref in _flatten(like).items():
        if k not in data:
            raise KeyError(f"checkpoint missing leaf {k}")
        got = data.pop(k)
        want = manifest["leaves"][k]["shape"]
        if list(got.shape) != want or list(got.shape) != list(np.shape(ref)):
            raise ValueError(f"shape mismatch for {k}: ckpt {got.shape}, "
                             f"manifest {want}, model {tuple(np.shape(ref))}")
        if manifest["leaves"][k]["dtype"] == "bfloat16":
            t = torch.from_numpy(got.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(got)
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        out[k] = t.to(dev)
    return _unflatten(like, out), manifest["step"], manifest["extra"]
