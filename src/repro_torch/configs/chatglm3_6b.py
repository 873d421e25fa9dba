"""ChatGLM3-6B [arXiv:2406.12793; hf] — GQA kv=2, 2d (partial) RoPE, QKV bias."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128, qkv_bias=True,
    rope_fraction=0.5,  # ChatGLM applies rotary to half the head dims (2d RoPE)
    source="arXiv:2406.12793; hf"))
