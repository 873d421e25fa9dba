"""IVF vector-search index over GK-means coarse quantization.

Counterpart of ``repro.index``: ``build_ivf`` packs a ``GKMeansResult``
into tile-aligned inverted lists, ``search`` probes the top-p cells per
query (``probe_centroids``) and streams only their lists through
``ivf_scan``, ``ivf_scan_grouped`` (``qgroup=G``) or, over int8/PQ codes
attached by ``quantize_index``, ``ivf_scan_adc`` with an exact-rerank tail;
``add`` assigns new rows through ``assign_centroids``, and ``store`` reads
and writes the reference's on-disk format.
"""
from repro_torch.index import store
from repro_torch.index.ivf import (IvfIndex, ShardedLists, add, attach_codec,
                                   build_ivf, quantize_index, remove, repack,
                                   shard_lists)
from repro_torch.index.probe import (build_group_map, build_tile_map,
                                     exhaustive_search, merge_probe_cells,
                                     merge_shard_topk, scan_fraction, search)
from repro_torch.index.quantize import (Int8Codec, PqCodec, bytes_per_row,
                                        train_int8, train_pq)
from repro_torch.index.store import index_nbytes, load_index, save_index

__all__ = [
    "Int8Codec", "IvfIndex", "PqCodec", "ShardedLists", "add",
    "attach_codec", "build_group_map", "build_ivf", "build_tile_map",
    "bytes_per_row", "exhaustive_search", "index_nbytes", "load_index",
    "merge_probe_cells", "merge_shard_topk", "quantize_index",
    "remove", "repack", "save_index", "scan_fraction", "search",
    "shard_lists", "store", "train_int8", "train_pq",
]
