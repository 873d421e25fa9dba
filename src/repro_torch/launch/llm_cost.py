"""Analytic LLM cost models (transformer/SSM/MoE/hybrid/audio families);
a copy of ``repro.launch.llm_cost``, which is pure arithmetic over a config
and imports nothing.

These are the config-driven FLOP / HBM / parameter-count estimators that
the training example (``examples/train_lm_torch.py``) and the LLM dry-run
tooling read to sanity-check a program against an analytic model.  They
model *language-model* shapes (layers, heads, KV caches, optimizers) and
are separate from the clustering/ANN kernel roofline in
``launch.roofline``, which keeps the hardware constants and the kernel
inventory.

All functions take a model ``cfg`` (attribute access; a
``repro_torch.configs.ArchConfig``) and, where relevant, a ``shape`` with
``kind`` in {"train", "prefill", "decode"}, ``global_batch`` and
``seq_len`` (a ``configs.ShapeSpec``).
"""
from __future__ import annotations


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); decode D=tokens=B."""
    n_params, n_active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def flops_analytic(cfg, shape, chips: int) -> float:
    """Exact per-chip FLOPs of the implemented program (ideal SPMD split).

    Counts every matmul as implemented: attention computes the full S^2
    score matrix (no causal skip — see §Perf), training applies x4 over
    forward (backward = 2x, full remat recompute = 1x).
    """
    B, S = shape.global_batch, shape.seq_len
    D, V = cfg.d_model, cfg.vocab
    T = B * S
    kind = shape.kind

    def attn_flops(tokens, kv_len, layers, heads):
        proj = 2 * tokens * D * (cfg.n_heads + 2 * cfg.n_kv_heads) * \
            cfg.head_dim + 2 * tokens * cfg.n_heads * cfg.head_dim * D
        scores = 4 * tokens * kv_len * heads * cfg.head_dim
        if cfg.causal_skip and kind != "decode":
            scores *= 0.5  # triangular kv schedule (attention.py)
        return layers * (proj + scores)

    def mlp_flops(tokens, layers):
        if cfg.family == "moe":
            routed = 6 * tokens * D * cfg.moe_d_ff * cfg.experts_per_token
            shared = 6 * tokens * D * cfg.n_shared_experts * cfg.moe_d_ff
            return layers * (routed + shared)
        mult = 6 if cfg.mlp_act == "swiglu" else 4
        return layers * mult * tokens * D * cfg.d_ff

    def mamba_flops(tokens, layers):
        Di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        proj = 2 * tokens * D * (2 * Di + 2 * N + H) + 2 * tokens * Di * D
        Q = cfg.ssd_chunk if kind != "decode" else 1
        # SSD: scores CB^T (2*t*Q*N), diag apply (2*t*Q*H*P), states+off
        ssd = tokens * (2 * Q * N + 2 * Q * H * P + 4 * N * H * P)
        return layers * (proj + ssd)

    def rec_flops(tokens, layers):
        Wd = cfg.lru_width
        return layers * (2 * tokens * D * 2 * Wd + 4 * tokens * Wd * Wd
                         + 2 * tokens * Wd * D
                         + 6 * tokens * D * cfg.d_ff)

    if kind == "decode":
        tokens, kv = B, S
    elif kind == "prefill":
        tokens, kv = T, S
    else:
        tokens, kv = T, S

    f = 2.0 * tokens * D * cfg.vocab_padded  # lm head
    if cfg.family == "ssm":
        f += mamba_flops(tokens, cfg.n_layers)
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern
        ng = cfg.n_layers // len(pat)
        n_rec = sum(1 for k in pat if k == "rec") * ng + \
            (cfg.n_layers - ng * len(pat))
        n_att = cfg.n_layers - n_rec
        kv_eff = min(kv, cfg.window) if cfg.window else kv
        f += rec_flops(tokens, n_rec)
        f += attn_flops(tokens, kv_eff, n_att, cfg.n_heads)
    elif cfg.family == "audio":
        f += attn_flops(tokens, kv, cfg.enc_layers + cfg.n_layers,
                        cfg.n_heads)
        f += mlp_flops(tokens, cfg.enc_layers + cfg.n_layers)
        # cross attention: q-proj+out + scores over enc len
        f += cfg.n_layers * (4 * tokens * D * cfg.n_heads * cfg.head_dim
                             + 4 * tokens * kv * cfg.n_heads * cfg.head_dim)
    else:
        f += attn_flops(tokens, kv, cfg.n_layers, cfg.n_heads)
        f += mlp_flops(tokens, cfg.n_layers)
    if kind == "train":
        # bwd 2x (+ full-remat recompute 1x)
        f *= 4.0 if cfg.remat_policy == "full" else 3.0
    return f / chips


def hbm_analytic(cfg, shape, chips: int) -> float:
    """Modeled per-chip HBM traffic per step (stated-assumption lower bound).

    train:  params 2B read (fwd) + 2B read (remat recompute) + 2B grad write
            + AdamW m/v read+write fp32 (16B) + 2B param write = 24 B/param
            (adafactor: 8 B/param), all sharded over every chip;
            activations: remat saves layer inputs -> ~4 passes over T*D per
            layer plus in-layer working set ~4x that.
    prefill: params 2B read + KV cache write + activation stream.
    decode:  params 2B read + full KV/state cache read + tiny writes.
    """
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    T = B * S
    n_params, _ = param_counts(cfg)
    kind = shape.kind

    if kind == "train":
        per_param = 24.0 if cfg.optimizer == "adamw" else 8.0
        act = 20.0 * cfg.n_layers * T * D * 2  # global bytes
        return (n_params * per_param + act) / chips
    if kind == "prefill":
        act = 12.0 * cfg.n_layers * T * D * 2
        cache = _cache_bytes(cfg, B, S)
        return (n_params * 2.0 + act + cache) / chips
    # decode
    cache = _cache_bytes(cfg, B, S)
    return (n_params * 2.0 + cache) / chips


def _cache_bytes(cfg, B: int, S: int) -> float:
    if cfg.family == "ssm":
        return cfg.n_layers * B * (cfg.ssm_heads * cfg.ssm_head_dim
                                   * cfg.ssm_state * 4
                                   + (cfg.conv_width - 1) * cfg.d_inner * 2)
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        ng = cfg.n_layers // len(pat)
        n_att = sum(1 for k in pat if k == "attn") * ng
        n_rec = cfg.n_layers - n_att
        kv = n_att * B * min(S, cfg.window) * 2 * cfg.n_kv_heads * \
            cfg.head_dim * 2
        rec = n_rec * B * cfg.lru_width * (4 + 2 * (cfg.conv_width - 1))
        return kv + rec
    layers = cfg.n_layers
    kv = layers * B * S * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    if cfg.family == "audio":
        kv *= 2  # self + cross caches
    return kv


def param_counts(cfg) -> tuple:
    """(total, active-per-token) parameter counts from the config."""
    D, V = cfg.d_model, cfg.vocab
    emb = V * D * 2  # embed + lm_head
    if cfg.family == "ssm":
        Di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = D * (2 * Di + 2 * N + H) + Di * D + 4 * Di + 3 * H + Di
        tot = cfg.n_layers * per + emb
        return tot, tot
    att = D * cfg.n_heads * cfg.head_dim + 2 * D * cfg.n_kv_heads * \
        cfg.head_dim + cfg.n_heads * cfg.head_dim * D
    if cfg.family == "moe":
        ffn_tot = 3 * D * cfg.moe_d_ff * cfg.n_experts
        ffn_act = 3 * D * cfg.moe_d_ff * cfg.experts_per_token
        if cfg.n_shared_experts:
            sh = 3 * D * cfg.n_shared_experts * cfg.moe_d_ff
            ffn_tot += sh
            ffn_act += sh
        tot = cfg.n_layers * (att + ffn_tot) + emb
        act = cfg.n_layers * (att + ffn_act) + emb
        return tot, act
    ffn = 3 * D * cfg.d_ff if cfg.mlp_act == "swiglu" else 2 * D * cfg.d_ff
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        Wd = cfg.lru_width
        rec = D * 2 * Wd + 2 * Wd * Wd + Wd * D + 4 * Wd + ffn
        attn_l = att + ffn
        n_rec = sum(1 for k in pat if k == "rec") * (cfg.n_layers // len(pat))
        n_rec += cfg.n_layers - (cfg.n_layers // len(pat)) * len(pat)
        n_att = cfg.n_layers - n_rec
        tot = n_rec * rec + n_att * attn_l + emb
        return tot, tot
    layers = cfg.n_layers + cfg.enc_layers
    x_att = D * cfg.n_heads * cfg.head_dim * 2 if cfg.cross_attn else 0
    tot = layers * (att + ffn) + cfg.n_layers * x_att + emb
    return tot, tot
