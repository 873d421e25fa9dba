"""Index persistence in the reference's on-disk format.

Counterpart of ``repro.index.store``.  Flat format (``.ivf``): an 8-byte
little-endian header length, a JSON header padded so the data starts on a
64-byte boundary, then each array's raw bytes, every section 64-byte
aligned.  ``.npz`` (compressed) is also read and written.  An index with a
codec has the header key ``codec`` and the sections ``codes``, ``vnorm``
and ``int8_scale``/``int8_zero`` or ``pq_codebook``.  An index saved by
either package loads in the other.

``load_index(mmap=True)`` keeps the index on the host: the flat format maps
every section with ``np.memmap`` and wraps it with ``torch.from_numpy``, so
nothing is read until it is touched and nothing is copied.  A stated
difference: the reference maps read-only (its arrays are immutable
anyway); here the mapping is copy-on-write (mode ``"c"``), so the tensors
are writable and a write to them changes private pages, never the file
(``add`` and ``remove`` return new tensors in any case).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.index.ivf import IvfIndex
from repro_torch.index.quantize import Int8Codec, PqCodec

_ALIGN = 64
_MAGIC = "repro-ivf-v1"
_ARRAYS = ("centroids", "vecs", "ids", "starts", "caps")
# extra sections when a codec is attached, by codec kind
_CODEC_ARRAYS = {"int8": ("int8_scale", "int8_zero"), "pq": ("pq_codebook",)}
_DTYPES = {"centroids": np.float32, "vecs": np.float32, "ids": np.int32,
           "starts": np.int32, "caps": np.int32, "codes": np.uint8,
           "vnorm": np.float32, "int8_scale": np.float32,
           "int8_zero": np.float32, "pq_codebook": np.float32}


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def save_index(index: IvfIndex, path: str) -> None:
    """Write the index to ``path`` (.npz suffix -> npz, else flat binary)."""
    tensors = {name: getattr(index, name) for name in _ARRAYS}
    meta = {"magic": _MAGIC, "block_rows": index.block_rows,
            "repack_threshold": index.repack_threshold}
    if index.codec is not None:
        meta["codec"] = index.codec.kind
        tensors["codes"], tensors["vnorm"] = index.codes, index.vnorm
        if index.codec.kind == "int8":
            tensors["int8_scale"] = index.codec.scale
            tensors["int8_zero"] = index.codec.zero
        else:
            tensors["pq_codebook"] = index.codec.codebook
    arrays = {name: t.detach().cpu().numpy().astype(_DTYPES[name], copy=False)
              for name, t in tensors.items()}
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


def _names(meta: dict, path: str):
    """The sections a file must hold: the f32 index, plus its codec's."""
    kind = meta.get("codec")
    if kind is None:
        return _ARRAYS
    if kind not in _CODEC_ARRAYS:
        raise ValueError(f"{path}: unknown codec kind {kind!r}")
    return _ARRAYS + ("codes", "vnorm") + _CODEC_ARRAYS[kind]


def load_index(path: str, *, device: DeviceLike = None,
               mmap: bool = False) -> IvfIndex:
    """Read an index written by ``save_index`` (either package) onto
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU).

    ``mmap=True`` keeps the index on the host (``device`` must be None or
    ``"cpu"``): a flat file's sections become copy-on-write memory maps,
    read only when touched; an npz loads into host tensors.  Serve it on
    the card after ``index.to("cuda")``.
    """
    if mmap:
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError("load_index(mmap=True) keeps the index on the "
                             f"host; got device={device!r}")
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            try:
                meta = json.loads(str(z["meta"]))
            except KeyError as e:
                raise ValueError(f"not a repro IVF index: {path}") from e
            if meta.get("magic") != _MAGIC:
                raise ValueError(f"not a repro IVF index: {path}")
            arrays = {name: z[name] for name in _names(meta, path)}
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
            base = 8 + hlen
            arrays = {}
            for name in _names(meta, path):
                sec = meta["sections"][name]
                shape = tuple(sec["shape"])
                if mmap:
                    arrays[name] = np.memmap(path, dtype=sec["dtype"],
                                             mode="c",
                                             offset=base + sec["offset"],
                                             shape=shape)
                    continue
                f.seek(base + sec["offset"])
                a = np.fromfile(f, dtype=sec["dtype"],
                                count=int(np.prod(shape)))
                arrays[name] = a.reshape(shape)
    t = {name: torch.from_numpy(np.ascontiguousarray(
        a, dtype=_DTYPES[name])).to(dev) for name, a in arrays.items()}
    codec = None
    if meta.get("codec") == "int8":
        codec = Int8Codec(scale=t.pop("int8_scale"), zero=t.pop("int8_zero"))
    elif meta.get("codec") == "pq":
        codec = PqCodec(codebook=t.pop("pq_codebook"))
    return IvfIndex.from_arrays(block_rows=meta["block_rows"],
                                repack_threshold=meta["repack_threshold"],
                                codec=codec, **t)


def index_nbytes(path: str) -> int:
    return os.path.getsize(path)
