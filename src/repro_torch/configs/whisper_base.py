"""Whisper-base [arXiv:2212.04356] — enc-dec; conv audio frontend is a STUB
(input_specs() provides precomputed frame embeddings)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    enc_layers=6, cross_attn=True, frontend="audio_stub", frontend_dim=512,
    pos_embedding="sinusoidal", mlp_act="gelu", norm_type="layer",
    source="arXiv:2212.04356; unverified"))
