"""Grok-1 314B [hf:xai-org/grok-1] — MoE 8 experts top-2, GQA kv=8."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, experts_per_token=2, moe_d_ff=32768,
    # act_sharding off: the per-layer batch constraint forces a reshard
    # against the MoE capacity-dispatch layout and ADDED traffic (§Perf,
    # measured 0.8x) — expert-parallel all-to-all dispatch is future work.
    act_sharding=False,
    optimizer="adafactor", source="hf:xai-org/grok-1; unverified"))
