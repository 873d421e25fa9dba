"""Synthetic data generators of the port."""
from repro_torch.data.synthetic import gmm_blobs, sift_like

__all__ = ["gmm_blobs", "sift_like"]
