"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts top-4
+ 4 shared experts, expert d_ff=1408."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128, qkv_bias=True,
    n_experts=60, experts_per_token=4, n_shared_experts=4, moe_d_ff=1408,
    # act_sharding off: the per-layer batch constraint forces a reshard
    # against the MoE capacity-dispatch layout and ADDED traffic (§Perf,
    # measured 0.8x) — expert-parallel all-to-all dispatch is future work.
    act_sharding=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf"))
