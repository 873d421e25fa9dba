"""Synthetic data generators of the port."""
from repro_torch.data.synthetic import gmm_blobs, sift_like, token_batch

__all__ = ["gmm_blobs", "sift_like", "token_batch"]
