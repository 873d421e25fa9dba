"""The port's configurations: the paper's clustering workloads
(``configs.gkmeans_paper``)."""
from repro_torch.configs.gkmeans_paper import (GIST1M, GLOVE1M, SIFT1M,
                                               SIFT_SMALL, VLAD10M,
                                               VLAD_SMALL, ClusterConfig)

__all__ = ["ClusterConfig", "SIFT1M", "VLAD10M", "GLOVE1M", "GIST1M",
           "SIFT_SMALL", "VLAD_SMALL"]
