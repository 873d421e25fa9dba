"""Roofline bounds of the port on H100s (counterpart of
``repro.launch.roofline``): the kernels' bounds and the three-term
roofline of a rank's step.

  compute    = operations / peak rate of their type
  memory     = bytes / HBM rate
  collective = wire bytes / link rate

A kernel's bound is the larger of the two: the least time the card could
take for the call's work.  ``KERNEL_INVENTORY`` holds, for each of the
eight kernels, the operations and bytes one call needs as functions of its
shape, with the arguments named (for the scans, the live rows or union rows
the call reads, counted from the run's data: the work depends on it), and
the peak rate it is held to.  Bytes count each input read once and each
output written once.  ``chip_smoke.py`` prints every kernel's bound from
here, and ``launch/obs_report.py`` joins measured ``kernels`` records
against it.

The collective term takes the wire bytes a rank moves, as
``core.comm.collective_counter`` counts them from the calls it records
(the reference parses them out of compiled HLO, which torch has not), over
one GPU's link rate: NVLink within a node of eight, one NDR InfiniBand
port between nodes (``link_rate``).  ``launch/dryrun_cluster.py`` fills
all three terms for the paper's sharded workloads.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

# published peaks of one H100 SXM (NVIDIA data sheet; dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12       # outside the tensor cores
TF32_FLOPS = 495e12      # dense tensor-core rate
TF32X3_FLOPS = TF32_FLOPS / 3   # f32-accurate products as three TF32 ones
BF16_FLOPS = 989e12      # dense tensor-core rate, f32 accumulation
# links of one H100 SXM GPU: NVLink 4 within a node of 8 (NVIDIA data
# sheet: 900 GB/s both ways together, so 450 GB/s each way), and between
# nodes one 400 Gb/s NDR InfiniBand port a GPU (50 GB/s each way)
NVLINK_BYTES_PER_S = 450e9
NDR_BYTES_PER_S = 50e9
GPUS_PER_NODE = 8


def _fp32(**_) -> float:
    return FP32_FLOPS


KERNEL_INVENTORY: Dict[str, Dict[str, Any]] = {
    "gather_score": dict(
        desc="ΔI / lloyd move scores of B samples against their C candidate "
             "clusters and their own (C+1 rows of D gathered, one dot "
             "each); D and cnt read once (they stay in L2)",
        flops=lambda B, C, d, k: 4.0 * B * (C + 1) * d,
        hbm_bytes=lambda B, C, d, k: 4.0 * (B * d + B + B * C + k * d + k
                                            + B * C),
        peak=_fp32,
    ),
    "refine_merge": dict(
        desc="exact L2 from B rows to C candidate rows each, merged into "
             "sorted κ lists; uniq_rows distinct candidate rows read once, "
             "pairs the valid (row, candidate) pairs",
        flops=lambda B, C, kappa, d, uniq_rows, pairs: (
            2.0 * pairs * d + 3.0 * pairs + kappa * (kappa + C) * B),
        hbm_bytes=lambda B, C, kappa, d, uniq_rows, pairs: (
            4.0 * (B * d + 2 * B * C + 2 * B * kappa) + uniq_rows * (d * 4 + 4)
            + 8.0 * B * kappa),
        peak=_fp32,
    ),
    "probe_centroids": dict(
        desc="top-p nearest centroids of n rows among k (IVF probe, the "
             "engine's probe source)",
        flops=lambda n, k, d, p: 2.0 * n * k * d,
        hbm_bytes=lambda n, k, d, p: 4.0 * (n * d + k * d + 2 * n * p),
        peak=_fp32,
    ),
    "assign_centroids": dict(
        desc="nearest centroid and its d2 for n rows among k, f32 products "
             "as 3xTF32 on the tensor cores",
        flops=lambda n, k, d: 2.0 * n * k * d,
        hbm_bytes=lambda n, k, d: 4.0 * (n * d + k * d + 2 * n),
        peak=lambda **_: TF32X3_FLOPS,
    ),
    "ivf_scan": dict(
        desc="per-query walk of the probed list tiles with a running top-k; "
             "rows: live rows scanned over all nq queries",
        flops=lambda nq, rows, d, topk: 2.0 * rows * d,
        hbm_bytes=lambda nq, rows, d, topk: 4.0 * (nq * d + rows * d
                                                   + 2 * nq * topk),
        peak=_fp32,
    ),
    "ivf_scan_adc": dict(
        desc="the same walk over u8 codes through a per-query (M, W) table; "
             "M + 4 bytes a scanned row",
        flops=lambda nq, rows, M, W, topk: 2.0 * rows * M,
        hbm_bytes=lambda nq, rows, M, W, topk: (4.0 * nq * M * W
                                                + rows * (M + 4.0)
                                                + 12.0 * nq * topk),
        peak=_fp32,
    ),
    "ivf_scan_grouped": dict(
        desc="G queries walk their group's deduped union of tiles once; "
             "union_rows: live union rows over all groups, pairs: live "
             "(query, row) pairs scored",
        flops=lambda nq, union_rows, pairs, d, topk: 2.0 * pairs * d,
        hbm_bytes=lambda nq, union_rows, pairs, d, topk: 4.0 * (
            nq * d + union_rows * d + 2 * nq * topk),
        peak=_fp32,
    ),
    "pairwise_sq": dict(
        desc="batched (B, m, m) within-cluster squared L2; one triangle of "
             "dots (diagonal included) a cluster; bf16 input (itemsize 2) on "
             "the tensor cores",
        flops=lambda B, m, d, itemsize: float(B * m * (m + 1) * d),
        hbm_bytes=lambda B, m, d, itemsize: (4.0 * B * m * m
                                             + itemsize * B * m * d),
        peak=lambda B, m, d, itemsize: (BF16_FLOPS if itemsize == 2
                                        else FP32_FLOPS),
    ),
}


def link_rate(ranks: int) -> float:
    """Bytes/s each way of one GPU's links in a group of ``ranks``: NVLink
    when the group fits one node, else the NDR port."""
    return NVLINK_BYTES_PER_S if ranks <= GPUS_PER_NODE else NDR_BYTES_PER_S


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float = 0.0,
                   *, peak: float = FP32_FLOPS,
                   hbm: float = HBM_BYTES_PER_S,
                   link: float = NVLINK_BYTES_PER_S) -> Dict[str, Any]:
    """The compute, memory and collective terms in seconds, which one binds
    ("memory" on a tie with compute; "collective" only when it is the
    largest) and the compute term's share of the largest
    (``roofline_fraction``)."""
    t_c = flops / peak
    t_m = hbm_bytes / hbm
    t_x = coll_bytes / link
    dom = "memory" if t_m >= t_c else "compute"
    if t_x > max(t_c, t_m):
        dom = "collective"
    top = max(t_c, t_m, t_x)
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bottleneck": dom,
            "roofline_fraction": t_c / top if top > 0 else 0.0}


def kernel_terms(name: str, peak: Optional[float] = None,
                 **shape) -> Dict[str, Any]:
    """``roofline_terms`` of one call of kernel ``name`` at ``shape`` (its
    inventory arguments, by name), plus ``flops``, ``hbm_bytes`` and
    ``bound_s``; ``peak`` overrides the inventory's rate."""
    inv = KERNEL_INVENTORY[name]
    flops = inv["flops"](**shape)
    nbytes = inv["hbm_bytes"](**shape)
    terms = roofline_terms(
        flops, nbytes, peak=inv["peak"](**shape) if peak is None else peak)
    terms.update(flops=flops, hbm_bytes=nbytes,
                 bound_s=max(terms["compute_s"], terms["memory_s"]))
    return terms
