"""Carry the JAX package's state, given as numpy arrays, into the port.

The clustering system's counterpart of carrying weights across: one
reference graph, one initial state, one set of epoch keys, one packed IVF
index (or its per-shard re-pack), one set of clustered-KV clusters and one
LM's weights and KV cache can be fed to both packages, so their outputs
compare like with like.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.engine import BKMState
from repro_torch.core.knn_graph import KnnGraph
from repro_torch.core.kv_cluster import KVClusters
from repro_torch.index.ivf import IvfIndex, ShardedLists
from repro_torch.index.quantize import Int8Codec, PqCodec
from repro_torch.models.model import Cache, Model, _hybrid_counts


def _tensor(a, dtype, device) -> torch.Tensor:
    """An owned, contiguous copy of array ``a`` (arrays handed over from
    JAX are read-only)."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def knn_graph(ids, dist, device: DeviceLike = None) -> KnnGraph:
    """KnnGraph from (n, κ) neighbour ids and squared distances, on
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    return KnnGraph(_tensor(ids, np.int32, dev),
                    _tensor(dist, np.float32, dev))


def bkm_state(assign, D, cnt, device: DeviceLike = None) -> BKMState:
    """BKMState from an (n,) assignment, (k, d) composites, (k,) counts, on
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    return BKMState(_tensor(assign, np.int32, dev),
                    _tensor(D, np.float32, dev),
                    _tensor(cnt, np.float32, dev),
                    torch.zeros((), dtype=torch.int32, device=dev))


def kv_clusters(centroids, table, radii, device: DeviceLike = None
                ) -> KVClusters:
    """KVClusters from (B, Hkv, kc, hd) centroids, (B, Hkv, kc, cap) member
    tables and (B, Hkv, kc) radii (a ``repro.core.kv_cluster.KVClusters``'s
    fields as numpy), on ``device`` (default ``cuda``; pass
    ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    return KVClusters(_tensor(centroids, np.float32, dev),
                      _tensor(table, np.int32, dev),
                      _tensor(radii, np.float32, dev))


def epoch_words(words) -> torch.Tensor:
    """(epochs, 4) uint32 subkey words (e.g. ``jax.random.bits(key, (4,))``
    per epoch) as the int64 CPU tensor ``engine.run(epoch_words=...)``
    takes."""
    return _tensor(np.asarray(words, dtype=np.uint64).reshape(-1, 4),
                   np.int64, "cpu")


def ivf_index(centroids, vecs, ids, starts, caps, block_rows: int,
              repack_threshold: float = 0.5, device: DeviceLike = None, *,
              codes=None, vnorm=None, int8_scale=None, int8_zero=None,
              pq_codebook=None) -> IvfIndex:
    """IvfIndex from a packed index's arrays (a ``repro.index.IvfIndex``'s
    fields as numpy), row for row, on ``device`` (default ``cuda``; pass
    ``device="cpu"`` for the CPU).

    A compressed payload comes across with ``codes`` and ``vnorm`` and the
    codec's arrays: ``int8_scale`` and ``int8_zero`` (the reference's
    ``Int8Codec.scale``/``.zero``) or ``pq_codebook`` (``PqCodec.codebook``)
    — the sections a saved index holds.
    """
    dev = resolve_device(device)
    codec = None
    if int8_scale is not None:
        codec = Int8Codec(_tensor(int8_scale, np.float32, dev),
                          _tensor(int8_zero, np.float32, dev))
    elif pq_codebook is not None:
        codec = PqCodec(_tensor(pq_codebook, np.float32, dev))
    if (codec is None) != (codes is None) or (codes is None) != (
            vnorm is None):
        raise ValueError("a codec needs codes, vnorm and its own arrays")
    return IvfIndex.from_arrays(
        _tensor(centroids, np.float32, dev), _tensor(vecs, np.float32, dev),
        _tensor(ids, np.int32, dev), _tensor(starts, np.int32, dev),
        _tensor(caps, np.int32, dev), block_rows, repack_threshold, codec,
        None if codes is None else _tensor(codes, np.uint8, dev),
        None if vnorm is None else _tensor(vnorm, np.float32, dev))


def sharded_lists(vecs, ids, starts, caps, owner, rows_loc: int, shards: int,
                  codes=None, vnorm=None,
                  device: DeviceLike = None) -> ShardedLists:
    """ShardedLists from the arrays of a reference ``shard_lists`` result
    (``repro.index.ivf.ShardedLists``'s fields as numpy), array for array,
    on ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU);
    ``owner`` stays on the CPU, as the port keeps it."""
    dev = resolve_device(device)
    return ShardedLists(
        _tensor(vecs, np.float32, dev), _tensor(ids, np.int32, dev),
        _tensor(starts, np.int32, dev), _tensor(caps, np.int32, dev),
        _tensor(owner, np.int64, "cpu"), int(rows_loc), int(shards),
        None if codes is None else _tensor(codes, np.uint8, dev),
        None if vnorm is None else _tensor(vnorm, np.float32, dev))


def _same_dtype(a, device) -> torch.Tensor:
    """An owned copy of array or tensor ``a`` in its own dtype; numpy's
    bfloat16 (``ml_dtypes``, as JAX hands bf16 arrays over) crosses as its
    bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16)))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params(params, cfg, device: DeviceLike = None) -> Model:
    """A ``Model`` holding the reference's parameter pytree (nested dicts
    of arrays or tensors, layers stacked on axis 0, e.g.
    ``jax.tree.map(np.asarray, init_params(cfg, key))`` or a
    ``train.checkpoint.restore`` of a file the reference wrote), leaf for leaf and in its dtypes (bf16
    matrices, float32 norms and biases; an MoE layer's ``moe`` subtree
    with its router, experts and ``shared`` MLP; a Mamba-2 layer's
    projections, conv, ``A_log``, ``Dskip``, ``dt_bias`` and norms; for
    the hybrid family ``groups`` of ``b{i}_rec``/``b{i}_attn`` subtrees
    stacked over the groups and ``tail``, the recurrent layers left over,
    stacked over those; for audio ``enc_layers`` and ``dec_layers``, the
    decoder's with ``lnx`` and ``xattn``; for vlm also ``patch_proj``), on
    ``device`` (default ``cuda``; pass ``device="cpu"`` for the CPU).

    Raises ``ValueError`` unless the tree and the model hold the same
    leaves: a leaf the model lacks, a parameter the tree lacks, a stacked
    leaf with another count than the config's (``n_layers`` layers, or
    ``n_layers // len(block_pattern)`` groups and the rest in the tail, or
    ``enc_layers`` encoder and ``n_layers`` decoder layers), or another
    shape or dtype."""
    model = Model(cfg, device)
    dev = model.device
    own = dict(model.named_parameters())
    loaded = set()

    def load(name, a):
        if name not in own:
            raise ValueError(f"{name}: in the tree, not in the model")
        t = _same_dtype(a, dev)
        if t.dtype != own[name].dtype or t.shape != own[name].shape:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} against "
                             f"{tuple(own[name].shape)} {own[name].dtype}")
        own[name].copy_(t)
        loaded.add(name)

    def walk(prefix, tree, layer=None, n=0, unit=""):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                walk(f"{prefix}{key}.", sub, layer, n, unit)
            elif layer is None:
                load(prefix + key, sub)
            elif np.shape(sub)[0] != n:
                raise ValueError(f"{prefix}{key}: {np.shape(sub)[0]} {unit} "
                                 f"stacked, the config has {n}")
            else:
                load(prefix + key, sub[layer])

    if cfg.family == "hybrid":
        G, T = _hybrid_counts(cfg)
        stacks = {"groups": (G, "groups"), "tail": (T, "layers")}
    elif cfg.family == "audio":
        stacks = {"enc_layers": (cfg.enc_layers, "encoder layers"),
                  "dec_layers": (cfg.n_layers, "decoder layers")}
    else:
        stacks = {"layers": (cfg.n_layers, "layers")}
    stacks = {k: v for k, v in stacks.items() if v[0] and k in params}
    walk("", {k: v for k, v in params.items() if k not in stacks})
    for key, (n, unit) in stacks.items():
        for i in range(n):
            walk(f"{key}.{i}.", params[key], i, n, unit)
    missing = sorted(set(own) - loaded)
    if missing:
        raise ValueError(f"not in the tree: {', '.join(missing)}")
    return model


def lm_cache(cache, device: DeviceLike = None) -> Cache:
    """The port's cache from the reference's, on ``device`` (default
    ``cuda``; pass ``device="cpu"`` for the CPU): a KV cache (``k``, ``v``
    of (L, B, S, Hkv, hd) bf16; Whisper's also ``xk``, ``xv``), an SSM
    cache (``state`` (L, B, H, P, N)
    float32, ``conv`` (L, B, W-1, d_inner) bf16) or a hybrid cache
    (``groups`` mapping ``b{i}`` to an (h, conv tail) or (k, v) ring pair,
    ``tail`` an (h, conv tail) pair), told apart by their keys, each array
    in its own dtype and a copy of its own (the reference's ``init_cache``
    hands one array over as both k and v); the scalar ``len`` becomes a
    host int."""
    dev = resolve_device(device)
    if "groups" in cache:
        out = {"groups": {k: tuple(_same_dtype(a, dev) for a in pair)
                          for k, pair in cache["groups"].items()},
               "len": int(cache["len"])}
        if "tail" in cache:
            out["tail"] = tuple(_same_dtype(a, dev) for a in cache["tail"])
        return out
    keys = (("state", "conv") if "state" in cache
            else ("k", "v", "xk", "xv") if "xk" in cache else ("k", "v"))
    return {**{k: _same_dtype(cache[k], dev) for k in keys},
            "len": int(cache["len"])}
