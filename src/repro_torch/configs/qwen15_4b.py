"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B] — dense MHA (kv==q heads), QKV bias."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, head_dim=128, qkv_bias=True,
    source="hf:Qwen/Qwen1.5-4B; hf"))
