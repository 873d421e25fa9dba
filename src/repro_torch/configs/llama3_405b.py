"""Llama-3.1-405B [arXiv:2407.21783] — dense GQA, 128k vocab."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, head_dim=128,
    rope_base=5e5, optimizer="adafactor",  # 405B: factored optimizer state
    source="arXiv:2407.21783; unverified"))
