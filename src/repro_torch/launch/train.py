"""The reduced presets of the training launcher (counterpart of the top of
``repro.launch.train``): ``SMOKE``, ``M100`` and ``scaled_config``, which
``launch/serve.py`` and the tests read, as the reference's serve reads
them from its training launcher.  The training loop itself (deterministic
data, checkpoint/restart) comes with the second half of the training slice
(ROADMAP.md queue 1 item 5(e)); the loss, the optimizers and the train
step are ``Model.loss`` and ``repro_torch.train``.
"""
from __future__ import annotations

from repro_torch.configs import get_config

SMOKE = dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
             vocab=2048, head_dim=32, loss_chunk=256, attn_chunk=256)
# ~100M-param example preset (examples/train_lm.py)
M100 = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
            vocab=32768, head_dim=64, loss_chunk=512, attn_chunk=512)


def scaled_config(arch: str, preset: str):
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    kw = dict(SMOKE if preset == "smoke" else M100)
    if cfg.family == "ssm":
        kw.pop("n_heads"), kw.pop("n_kv_heads"), kw.pop("d_ff")
        kw.update(ssm_state=64, ssm_head_dim=32, ssd_chunk=64)
    if cfg.family == "moe":
        kw.update(n_experts=8, experts_per_token=2,
                  moe_d_ff=kw["d_ff"] // 4)
    if cfg.family == "hybrid":
        kw.update(n_heads=8, n_kv_heads=1, lru_width=kw["d_model"],
                  window=256, n_layers=5)
    if cfg.family == "audio":
        kw.update(enc_layers=2, frontend_dim=kw["d_model"])
    if cfg.family == "vlm":
        kw.update(frontend_dim=64, n_patches=16)
    return cfg.scaled(**kw)
