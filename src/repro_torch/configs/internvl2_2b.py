"""InternVL2-2B [arXiv:2404.16821; hf] — InternViT frontend (STUB patch
embeddings) + InternLM2-1.8B backbone."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128,
    frontend="patch_stub", frontend_dim=1024, n_patches=256,
    source="arXiv:2404.16821; hf"))
