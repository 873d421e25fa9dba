"""Model layers of the port that the clustering system compares against."""
from repro_torch.models.attention import decode_attention

__all__ = ["decode_attention"]
