"""IVF vector-search index over GK-means coarse quantization.

Counterpart of ``repro.index`` for f32 inverted lists: ``build_ivf`` packs
a ``GKMeansResult`` into tile-aligned inverted lists, ``search`` probes the
top-p cells per query (``probe_centroids``) and streams only their lists
through ``ivf_scan``, ``add`` assigns new rows through ``assign_centroids``,
and ``store`` reads and writes the reference's on-disk format.
"""
from repro_torch.index import store
from repro_torch.index.ivf import (IvfIndex, add, attach_codec, build_ivf,
                                   quantize_index, remove, repack,
                                   shard_lists)
from repro_torch.index.probe import (build_tile_map, exhaustive_search,
                                     scan_fraction, search)
from repro_torch.index.store import index_nbytes, load_index, save_index

__all__ = [
    "IvfIndex", "add", "attach_codec", "build_ivf", "build_tile_map",
    "exhaustive_search", "index_nbytes", "load_index", "quantize_index",
    "remove", "repack", "save_index", "scan_fraction", "search",
    "shard_lists", "store",
]
