"""GK-means core of the port: objective, engine, 2M trees, KNN graphs, the
paper's baselines, graph search and clustered-KV decode attention."""
from repro_torch.core.anns import graph_search
from repro_torch.core.bkm import BKMState, init_state, run_bkm
from repro_torch.core.closure import closure_kmeans
from repro_torch.core.engine import (CandidateSource, EngineConfig,
                                     dense_source, graph_source, probe_source)
from repro_torch.core.gkmeans import GKMeansResult, gk_means
from repro_torch.core.graph_build import (BuildDiagnostics, GraphBuildConfig,
                                          GraphBuilder, build_graph)
from repro_torch.core.knn_graph import (KnnGraph, build_knn_graph,
                                        graph_distances, merge_topk,
                                        random_graph)
from repro_torch.core.kv_cluster import (KVClusters, build_kv_clusters,
                                         candidate_recall,
                                         clustered_decode_attention)
from repro_torch.core.lloyd import init_kmeanspp, init_random, lloyd
from repro_torch.core.minibatch import minibatch_kmeans
from repro_torch.core.nn_descent import nn_descent
from repro_torch.core.objective import (ClusterStats, centroids,
                                        cluster_stats, delta_I,
                                        delta_I_brute, distortion,
                                        objective_I)
from repro_torch.core.recall import (brute_force_knn, cooccurrence_rate,
                                     recall_at, recall_top1)
from repro_torch.core.two_means import pad_plan, two_means_tree

__all__ = [
    "BKMState", "BuildDiagnostics", "CandidateSource", "ClusterStats",
    "EngineConfig", "GKMeansResult", "GraphBuildConfig", "GraphBuilder",
    "KVClusters", "KnnGraph",
    "brute_force_knn", "build_graph", "build_knn_graph", "build_kv_clusters",
    "candidate_recall", "clustered_decode_attention",
    "centroids", "closure_kmeans", "cluster_stats", "cooccurrence_rate",
    "delta_I", "delta_I_brute", "dense_source", "distortion", "gk_means",
    "graph_distances", "graph_search", "graph_source", "init_kmeanspp",
    "init_random", "init_state", "lloyd", "merge_topk", "minibatch_kmeans",
    "nn_descent", "objective_I", "pad_plan",
    "probe_source", "random_graph", "recall_at", "recall_top1", "run_bkm",
    "two_means_tree",
]
