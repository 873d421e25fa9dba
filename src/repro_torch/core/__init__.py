"""GK-means core of the port: objective, engine, 2M trees, KNN graph."""
from repro_torch.core.gkmeans import GKMeansResult, gk_means
from repro_torch.core.knn_graph import KnnGraph, build_knn_graph
from repro_torch.core.recall import brute_force_knn, recall_at

__all__ = ["GKMeansResult", "gk_means", "KnnGraph", "build_knn_graph",
           "brute_force_knn", "recall_at"]
