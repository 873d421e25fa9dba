"""RecurrentGemma-9B [arXiv:2402.19427] — Griffin: RG-LRU + local attention,
pattern (rec, rec, attn), MQA kv=1, window 2048."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), lru_width=4096, window=2048,
    source="arXiv:2402.19427; unverified"))
