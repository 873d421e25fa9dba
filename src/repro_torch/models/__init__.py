"""Model layers of the port: the dense decoder family (``Model``,
``build_model``) and the decode attention that clustered-KV decode is held
against."""
from repro_torch.models.attention import decode_attention
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model", "decode_attention"]
