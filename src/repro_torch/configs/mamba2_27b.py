"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    conv_width=4, source="arXiv:2405.21060; unverified"))
