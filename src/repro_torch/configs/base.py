"""Architecture config schema + registry + the assigned input shapes.

Counterpart of ``repro.configs.base``, field for field and property for
property, so one ``ArchConfig`` means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# the assigned LM shape set (applies to every assigned architecture)
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_fraction: float = 1.0    # <1 = partial rotary (ChatGLM "RoPE 2d")
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25  # train/prefill; decode never drops
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ('rec','rec','attn')
    lru_width: int = 0
    window: int = 0                        # local-attention window
    # --- enc-dec / multimodal ---
    enc_layers: int = 0
    cross_attn: bool = False
    frontend: str = "none"                 # none | audio_stub | patch_stub
    frontend_dim: int = 0                  # stub embedding dim
    n_patches: int = 256                   # vlm: patches prepended to text
    pos_embedding: str = "rope"            # rope | sinusoidal
    mlp_act: str = "swiglu"                # swiglu | gelu
    norm_type: str = "rms"                 # rms | layer
    # --- training ---
    optimizer: str = "adamw"               # adamw | adafactor
    remat: bool = True
    loss_chunk: int = 512
    attn_chunk: int = 1024
    ssd_chunk: int = 128
    source: str = ""
    # --- beyond-paper perf features (EXPERIMENTS.md §Perf; default off so
    #     the baseline stays paper/publication-faithful) ---
    pad_vocab_multiple: int = 0   # pad embed/lm_head rows for TP sharding
    causal_skip: bool = False     # skip fully-masked kv blocks in attention
    remat_policy: str = "full"    # full | dots (save matmul outputs)
    act_sharding: bool = True     # batch-shard activation constraints
    # (adopted as default after §Perf B3/A1: semantics-preserving, removed
    #  70-96% of collective traffic; baseline rows measured with False)

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_multiple
        if m <= 0:
            return self.vocab
        return ((self.vocab + m - 1) // m) * m

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def subquadratic(self) -> bool:
        """Supports long_500k decode (O(1)/O(window) state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def supports(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k" and not self.subquadratic:
            return False  # quadratic full attention — skipped per assignment
        return True

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **kw)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)
