"""Index persistence in the reference's on-disk format (f32 payloads).

Counterpart of ``repro.index.store``.  Flat format (``.ivf``): an 8-byte
little-endian header length, a JSON header padded so the data starts on a
64-byte boundary, then each array's raw bytes, every section 64-byte
aligned.  ``.npz`` (compressed) is also read and written.  An index saved
by either package loads in the other.  Files that carry a codec (int8/PQ
sections) are refused: compressed lists are not ported yet.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.index.ivf import IvfIndex

_ALIGN = 64
_MAGIC = "repro-ivf-v1"
_ARRAYS = ("centroids", "vecs", "ids", "starts", "caps")
_DTYPES = {"centroids": np.float32, "vecs": np.float32, "ids": np.int32,
           "starts": np.int32, "caps": np.int32}


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def save_index(index: IvfIndex, path: str) -> None:
    """Write the index to ``path`` (.npz suffix -> npz, else flat binary)."""
    arrays = {name: getattr(index, name).detach().cpu().numpy().astype(
        _DTYPES[name], copy=False) for name in _ARRAYS}
    meta = {"magic": _MAGIC, "block_rows": index.block_rows,
            "repack_threshold": index.repack_threshold}
    if path.endswith(".npz"):
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)
        return
    sections = {}
    off = 0  # relative to the end of the header block
    for name, a in arrays.items():
        sections[name] = {"dtype": str(a.dtype), "shape": list(a.shape),
                          "offset": off}
        off += _pad(a.nbytes)
    meta["sections"] = sections
    header = json.dumps(meta).encode()
    header += b" " * (_pad(len(header) + 8) - len(header) - 8)
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        base = f.tell()
        for name, a in arrays.items():
            f.seek(base + sections[name]["offset"])
            f.write(np.ascontiguousarray(a).tobytes())
        f.truncate(base + off)  # pad the last section, as the reference


def _refuse_codec(meta: dict, path: str) -> None:
    if "codec" in meta:
        raise NotImplementedError(
            f"{path} carries a {meta['codec']!r} codec: compressed lists are "
            "not ported yet (ROADMAP.md, item 1.9b)")


def load_index(path: str, *, device: DeviceLike = None) -> IvfIndex:
    """Read an index written by ``save_index`` (either package) onto
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            try:
                meta = json.loads(str(z["meta"]))
            except KeyError as e:
                raise ValueError(f"not a repro IVF index: {path}") from e
            if meta.get("magic") != _MAGIC:
                raise ValueError(f"not a repro IVF index: {path}")
            _refuse_codec(meta, path)
            arrays = {name: z[name] for name in _ARRAYS}
    else:
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            if not 0 < hlen <= os.path.getsize(path):
                raise ValueError(f"not a repro IVF index: {path}")
            try:
                meta = json.loads(f.read(hlen).decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"not a repro IVF index: {path}") from e
            if meta.get("magic") != _MAGIC:
                raise ValueError(f"not a repro IVF index: {path}")
            _refuse_codec(meta, path)
            base = 8 + hlen
            arrays = {}
            for name in _ARRAYS:
                sec = meta["sections"][name]
                f.seek(base + sec["offset"])
                a = np.fromfile(f, dtype=sec["dtype"],
                                count=int(np.prod(sec["shape"])))
                arrays[name] = a.reshape(sec["shape"])
    t = {name: torch.from_numpy(np.ascontiguousarray(
        arrays[name], dtype=_DTYPES[name])).to(dev) for name in _ARRAYS}
    return IvfIndex.from_arrays(block_rows=meta["block_rows"],
                                repack_threshold=meta["repack_threshold"],
                                **t)


def index_nbytes(path: str) -> int:
    return os.path.getsize(path)
