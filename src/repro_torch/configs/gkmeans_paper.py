"""The paper's own clustering workloads (Table 1 scales), as configs for
``chip_smoke.py``, the clustering dry run and the benchmark harness.

Counterpart of ``repro.configs.gkmeans_paper``, field for field: n rows of
d dimensions into k clusters, a κ-NN graph built in τ rounds of ξ-row
leaves.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ClusterConfig:
    name: str
    n: int
    d: int
    k: int
    kappa: int = 50
    xi: int = 64
    tau: int = 10


SIFT1M = ClusterConfig("sift1m", 1_000_000, 128, 10_000)
VLAD10M = ClusterConfig("vlad10m", 10_000_000, 512, 1_048_576)
GLOVE1M = ClusterConfig("glove1m", 1_000_000, 100, 10_000)
GIST1M = ClusterConfig("gist1m", 1_000_000, 960, 10_000)

# CPU-scaled analogues (same n:k:xi ratios, laptop-runnable)
SIFT_SMALL = ClusterConfig("sift-small", 65_536, 128, 1_024, kappa=32, tau=8)
VLAD_SMALL = ClusterConfig("vlad-small", 131_072, 128, 8_192, kappa=32, tau=8)
