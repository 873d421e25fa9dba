"""The dense, MoE, Mamba-2 (ssm), RecurrentGemma (hybrid), Whisper (audio)
and VLM families of the model zoo (counterpart of
``repro.models.model``).

A GQA transformer: RoPE (partial for ChatGLM), optional QKV bias, SwiGLU
or GELU MLP, RMS or layer norms, an untied ``lm_head`` and an optional
padded vocabulary.  The MoE family replaces each layer's MLP by the
capacity-dispatched top-k experts of ``models/moe.py`` plus, where the
config has them, shared experts (one SwiGLU MLP of ``n_shared_experts ·
moe_d_ff``); decode (S == 1) runs at capacity factor ``n_experts``, so it
never drops a token.  The ssm family is attention-free: each layer is a
Mamba-2 block (``models/ssm.py``'s chunked SSD scan over a depthwise causal
conv of x, gated by silu(z), out-normed).  The hybrid family repeats
``block_pattern`` (RecurrentGemma's (rec, rec, attn)) over ``n_layers //
3`` groups and ends in a tail of the recurrent layers left over: a
recurrent layer is an RG-LRU (``models/rglru.py``) over a causal conv of
its x branch, gated by a GELU branch, then an MLP; an attention layer is a
dense layer with local attention over the last ``window`` positions.
The audio family is Whisper's encoder-decoder: the frames (stub
embeddings of ``d_model``, as the reference's) plus a sinusoidal table
run through bidirectional dense blocks (no final norm on the encoder's
output, as the reference); the decoder embeds its tokens plus the same
table, and each of its blocks adds a non-causal cross-attention residual
over the encoder's output (its k and v projected without bias or
positions) between self-attention and the MLP.  The vlm family is the
dense decoder with the patches (stub embeddings of ``frontend_dim``)
projected by ``patch_proj`` and put before the token embeddings.
Entry points are the reference's serving ones: ``Model.prefill`` (builds
the cache, returns last-position logits) and ``Model.decode_step`` (one
token against the cache).

What is PyTorch idiom here rather than a copy:
- ``Model`` is an ``nn.Module`` on one device that holds its weights, in
  the reference's layouts and dtypes (bf16 matrices, float32 norms and
  biases); its layers are an ``nn.ModuleList`` of ``DenseBlock``s or
  ``MambaBlock``s walked in a loop, where the reference scans stacked
  leaves, and for the hybrid ``groups`` of ``HybridGroup`` (blocks
  ``b0_rec``, ``b1_rec``, ``b2_attn``) and ``tail`` of ``RecBlock``s, so a
  parameter's name (``groups.3.b2_attn.attn.wq``, ``tail.1.lam``) maps
  onto the reference's tree.  The reference's ``_norm_params``/
  ``_attn_params``/``_mlp_params``/``_moe_params``/``_dense_layer_params``/
  ``_mamba_layer_params``/``_rec_layer_params`` are the ``Norm``/
  ``Attention``/``Mlp``/``MoeFfn``/``DenseBlock``/``MambaBlock``/
  ``RecBlock`` constructors, with the reference's names (Whisper's
  ``enc_layers`` and ``dec_layers``, whose blocks carry ``lnx`` and
  ``xattn``; the VLM's ``patch_proj``), and
  ``init_params`` draws the weights from a ``torch.Generator``.  The SSD
  scan's chunk loop is a Python loop where the reference has ``lax.scan``.
- The cache is the reference's: k and v of (L, B, S, Hkv, hd) bf16; for
  ssm each layer's SSD ``state`` (L, B, H, P, N) float32 and ``conv`` tail
  (L, B, W-1, d_inner) in the activations' dtype; for the hybrid
  ``groups`` mapping ``b{i}`` to a recurrent block's (h (G, B, W) float32,
  conv tails) or an attention block's (k, v) rings (G, B, window, Hkv, hd)
  (position p at slot p mod window) and ``tail`` the tail layers' (h,
  conv tails); for audio also each decoder layer's cross-attention
  ``xk``/``xv`` (L, B, S_enc, Hkv, hd); plus ``len``, here a host int,
  so a decode step reads nothing back from the device.  ``decode_step``
  writes the new position (ssm: the new state and tail; hybrid: h, tails
  and the ring slot) into the caller's cache in place (the reference's
  server donates the cache to the step) and raises where the reference's
  ``dynamic_update_slice`` would clamp a write past the cache's end.
- ``_shard_act`` (an XLA mesh constraint that is the identity on one
  device) has no counterpart.

The backbone carries the MoE layers' auxiliary loss summed over layers,
as the reference's does; serving drops it and ``Model.loss`` adds 0.01 of
it.  Training is the reference's: ``Model.loss`` runs the backbone at
positions ``arange(S)`` (MoE at ``moe_capacity_factor``, so tokens drop as
in its prefill) into ``lm_loss``, the chunked-vocab cross entropy whose
(B, S, V) logits never exist; gradients come from autograd where the
reference takes ``jax.grad``, and ``torch.utils.checkpoint`` stands where
it applies ``jax.checkpoint``: each ``lm_loss`` chunk, and with
``cfg.remat`` one layer (one hybrid group, one tail layer, one encoder or
decoder layer) at a time, saving nothing (``remat_policy="full"``) or the
outputs of the products without a batch dimension (``"dots"``, selective
checkpointing).  Checkpointing applies only while autograd records, so
the serving steps (``torch.no_grad``) run as before.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as lru_lib
from repro_torch.models import ssm as ssm_lib

PDT = torch.bfloat16  # param dtype
Cache = Dict[str, Any]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ===========================================================================
# parameters (the reference's init helpers)
# ===========================================================================

class Norm(nn.Module):
    """``_norm_params``: ``w`` (d,) float32, an offset from 1 for RMS norm;
    layer norm also ``b``.  Zeros, as the reference initialises them."""

    def __init__(self, cfg: ArchConfig, d: int, device: torch.device):
        super().__init__()
        self.w = _param(torch.zeros(d, dtype=torch.float32, device=device))
        if cfg.norm_type == "layer":
            self.b = _param(torch.zeros(d, dtype=torch.float32,
                                        device=device))


class Attention(nn.Module):
    """``_attn_params``: wq (D, Hq, hd), wk/wv (D, Hkv, hd), wo (Hq, hd, D)
    bf16; with ``qkv_bias`` also bq (Hq, hd), bk/bv (Hkv, hd) float32, but
    never for cross-attention (``cross``)."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 cross: bool = False):
        super().__init__()
        D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        z = dict(dtype=PDT, device=device)
        self.wq = _param(torch.zeros((D, Hq, hd), **z))
        self.wk = _param(torch.zeros((D, Hkv, hd), **z))
        self.wv = _param(torch.zeros((D, Hkv, hd), **z))
        self.wo = _param(torch.zeros((Hq, hd, D), **z))
        self.qkv_bias = cfg.qkv_bias and not cross
        if self.qkv_bias:
            f = dict(dtype=torch.float32, device=device)
            self.bq = _param(torch.zeros((Hq, hd), **f))
            self.bk = _param(torch.zeros((Hkv, hd), **f))
            self.bv = _param(torch.zeros((Hkv, hd), **f))

    def init(self, g: torch.Generator, cfg: ArchConfig) -> None:
        D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        self.wq.copy_(L.dense_init(g, D, (Hq, hd), dtype=PDT))
        self.wk.copy_(L.dense_init(g, D, (Hkv, hd), dtype=PDT))
        self.wv.copy_(L.dense_init(g, D, (Hkv, hd), dtype=PDT))
        self.wo.copy_(L.dense_init(g, Hq * hd, (D,), dtype=PDT)
                      .reshape(Hq, hd, D))


class Mlp(nn.Module):
    """``_mlp_params``: SwiGLU w_gate/w_up (D, F) and w_down (F, D) bf16;
    GELU w_in (D, F), w_out (F, D) bf16 and b_in (F,), b_out (D,)
    float32.  F is ``d_ff`` where given (the shared experts'), else
    ``cfg.d_ff``."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 d_ff: Optional[int] = None):
        super().__init__()
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        self.act = cfg.mlp_act
        z = dict(dtype=PDT, device=device)
        if self.act == "gelu":
            self.w_in = _param(torch.zeros((D, Fd), **z))
            self.b_in = _param(torch.zeros(Fd, dtype=torch.float32,
                                           device=device))
            self.w_out = _param(torch.zeros((Fd, D), **z))
            self.b_out = _param(torch.zeros(D, dtype=torch.float32,
                                            device=device))
        else:
            self.w_gate = _param(torch.zeros((D, Fd), **z))
            self.w_up = _param(torch.zeros((D, Fd), **z))
            self.w_down = _param(torch.zeros((Fd, D), **z))

    def init(self, g: torch.Generator) -> None:
        D, Fd = (self.w_in if self.act == "gelu" else self.w_gate).shape
        if self.act == "gelu":
            self.w_in.copy_(L.dense_init(g, D, (Fd,), dtype=PDT))
            self.w_out.copy_(L.dense_init(g, Fd, (D,), dtype=PDT))
        else:
            self.w_gate.copy_(L.dense_init(g, D, (Fd,), dtype=PDT))
            self.w_up.copy_(L.dense_init(g, D, (Fd,), dtype=PDT))
            self.w_down.copy_(L.dense_init(g, Fd, (D,), dtype=PDT))


class MoeFfn(nn.Module):
    """``_moe_params``: router (D, E) float32, we_gate/we_up (E, D, F) and
    we_down (E, F, D) bf16 (F = ``moe_d_ff``); with ``n_shared_experts``
    also ``shared``, a SwiGLU ``Mlp`` of width ``n_shared_experts · F``."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = _param(torch.zeros((D, E), dtype=torch.float32,
                                         device=device))
        z = dict(dtype=PDT, device=device)
        self.we_gate = _param(torch.zeros((E, D, Fe), **z))
        self.we_up = _param(torch.zeros((E, D, Fe), **z))
        self.we_down = _param(torch.zeros((E, Fe, D), **z))
        self.shared = (Mlp(cfg, device, cfg.n_shared_experts * Fe)
                       if cfg.n_shared_experts else None)

    def init(self, g: torch.Generator) -> None:
        """The reference's draws: standard normals times ``D^-1/2`` (router
        in float32; gate and up) or ``F^-1/2`` (down), cast to bf16."""
        E, D, Fe = self.we_gate.shape

        def normal(shape, scale):
            return torch.randn(shape, generator=g, dtype=torch.float32,
                               device=g.device).mul_(scale)
        self.router.copy_(normal((D, E), D ** -0.5))
        self.we_gate.copy_(normal((E, D, Fe), D ** -0.5).to(PDT))
        self.we_up.copy_(normal((E, D, Fe), D ** -0.5).to(PDT))
        self.we_down.copy_(normal((E, Fe, D), Fe ** -0.5).to(PDT))
        if self.shared is not None:
            self.shared.init(g)


class DenseBlock(nn.Module):
    """``_dense_layer_params``: ln1, attn, ln2, and ``mlp`` (dense family)
    or ``moe`` (MoE family); with ``cross`` (Whisper's decoder) also
    ``lnx`` and ``xattn``, a cross-attention without QKV bias."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 cross: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        if cfg.family == "moe":
            self.moe = MoeFfn(cfg, device)
        else:
            self.mlp = Mlp(cfg, device)
        self.cross = cross
        if cross:
            self.lnx = Norm(cfg, cfg.d_model, device)
            self.xattn = Attention(cfg, device, cross=True)

    def init(self, g: torch.Generator, cfg: ArchConfig) -> None:
        """Draws attn, then the MLP or MoE layer, then ``xattn``."""
        self.attn.init(g, cfg)
        (self.moe if cfg.family == "moe" else self.mlp).init(g)
        if self.cross:
            self.xattn.init(g, cfg)


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)``'s arithmetic:
    ``start·(1 − t) + stop·t`` at t = i / (num − 1), the last value
    ``stop`` itself."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    t = torch.arange(num - 1, dtype=torch.float32) / (num - 1)
    return torch.cat([start * (1 - t) + stop * t,
                      torch.tensor([stop], dtype=torch.float32)])


class MambaBlock(nn.Module):
    """``_mamba_layer_params``: norm; wz, wx (D, d_inner), wB, wC (D, N),
    wdt (D, H), conv_x (W, d_inner) and wo (d_inner, D) bf16; conv_b
    (d_inner,), A_log, Dskip, dt_bias (H,) and out_norm (of d_inner)
    float32.  The reference's constants are set here: A_log = log(linspace(1,
    16, H)), Dskip = 1, dt_bias = −2; conv_b and the norms stay zero."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        D, Di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.conv_width)
        z = dict(dtype=PDT, device=device)
        f = dict(dtype=torch.float32, device=device)
        self.norm = Norm(cfg, D, device)
        self.wz = _param(torch.zeros((D, Di), **z))
        self.wx = _param(torch.zeros((D, Di), **z))
        self.wB = _param(torch.zeros((D, N), **z))
        self.wC = _param(torch.zeros((D, N), **z))
        self.wdt = _param(torch.zeros((D, H), **z))
        self.conv_x = _param(torch.zeros((W, Di), **z))
        self.conv_b = _param(torch.zeros(Di, **f))
        self.A_log = _param(torch.log(_linspace(1.0, 16.0, H)).to(device))
        self.Dskip = _param(torch.ones(H, **f))
        self.dt_bias = _param(torch.full((H,), -2.0, **f))
        self.out_norm = Norm(cfg, Di, device)
        self.wo = _param(torch.zeros((Di, D), **z))

    def init(self, g: torch.Generator, cfg: ArchConfig) -> None:
        """The reference's draws, in its order: fan-in truncated normals
        (wz, wx, wB, wC, wdt), conv_x standard normal · W^-½, then wo; each
        drawn in float32 and cast to bf16."""
        D, Di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.conv_width)
        for w, out in ((self.wz, Di), (self.wx, Di), (self.wB, N),
                       (self.wC, N), (self.wdt, H)):
            w.copy_(L.dense_init(g, D, (out,), dtype=PDT))
        self.conv_x.copy_(torch.randn((W, Di), generator=g,
                                      dtype=torch.float32, device=g.device)
                          .mul_(1.0 / W ** 0.5).to(PDT))
        self.wo.copy_(L.dense_init(g, Di, (D,), dtype=PDT))


class RecBlock(nn.Module):
    """``_rec_layer_params``: norm; w_x, w_gate (D, W), conv_w (conv
    width, W), w_r, w_i (W, W) and w_out (W, D) bf16; conv_b, lam, b_r,
    b_i (W,) float32; ln2 and a SwiGLU or GELU ``mlp`` (W = ``lru_width``).
    ``lam`` is the reference's constant ``linspace(0.5, 4.0, W)``; the
    biases and norms stay zero."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        D, Wd = cfg.d_model, cfg.lru_width
        z = dict(dtype=PDT, device=device)
        f = dict(dtype=torch.float32, device=device)
        self.norm = Norm(cfg, D, device)
        self.w_x = _param(torch.zeros((D, Wd), **z))
        self.w_gate = _param(torch.zeros((D, Wd), **z))
        self.conv_w = _param(torch.zeros((cfg.conv_width, Wd), **z))
        self.conv_b = _param(torch.zeros(Wd, **f))
        self.lam = _param(_linspace(0.5, 4.0, Wd).to(device))
        self.w_r = _param(torch.zeros((Wd, Wd), **z))
        self.b_r = _param(torch.zeros(Wd, **f))
        self.w_i = _param(torch.zeros((Wd, Wd), **z))
        self.b_i = _param(torch.zeros(Wd, **f))
        self.w_out = _param(torch.zeros((Wd, D), **z))
        self.ln2 = Norm(cfg, D, device)
        self.mlp = Mlp(cfg, device)

    def init(self, g: torch.Generator, cfg: ArchConfig) -> None:
        """The reference's draws, in its order: fan-in truncated normals
        (w_x, w_gate), conv_w a standard normal · 0.5, then w_r, w_i, w_out
        and the MLP; each drawn in float32 and cast to bf16."""
        D, Wd = cfg.d_model, cfg.lru_width
        self.w_x.copy_(L.dense_init(g, D, (Wd,), dtype=PDT))
        self.w_gate.copy_(L.dense_init(g, D, (Wd,), dtype=PDT))
        self.conv_w.copy_(torch.randn((cfg.conv_width, Wd), generator=g,
                                      dtype=torch.float32, device=g.device)
                          .mul_(0.5).to(PDT))
        for w in (self.w_r, self.w_i):
            w.copy_(L.dense_init(g, Wd, (Wd,), dtype=PDT))
        self.w_out.copy_(L.dense_init(g, Wd, (D,), dtype=PDT))
        self.mlp.init(g)


class HybridGroup(nn.Module):
    """One group of ``cfg.block_pattern``: block i is ``b{i}_rec`` (a
    ``RecBlock``) or ``b{i}_attn`` (a ``DenseBlock``), the reference's
    group subtree."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        for i, kind in enumerate(cfg.block_pattern):
            self.add_module(f"b{i}_{kind}", RecBlock(cfg, device)
                            if kind == "rec" else DenseBlock(cfg, device))

    def blocks(self, cfg: ArchConfig):
        """(i, kind, block) in the pattern's order."""
        return [(i, kind, getattr(self, f"b{i}_{kind}"))
                for i, kind in enumerate(cfg.block_pattern)]


def _hybrid_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups, tail layers): ``n_layers // len(pattern)`` groups and the
    recurrent layers left over."""
    G = cfg.n_layers // len(cfg.block_pattern)
    return G, cfg.n_layers - G * len(cfg.block_pattern)


# ===========================================================================
# blocks — sequence (prefill) path
# ===========================================================================

def _apply_norm(p: Norm, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return L.layer_norm(x, 1.0 + p.w, p.b, cfg.norm_eps)
    return L.rms_norm(x, p.w, cfg.norm_eps)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``: one matmul over the flattened
    heads."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)``."""
    return o.flatten(2) @ wo.flatten(0, 1)


def _qkv(p: Attention, h: torch.Tensor, cfg: ArchConfig,
         positions: torch.Tensor):
    """q, k, v (B, S, H, hd) of normed h: projections, bias (cast to the
    activations' dtype first), RoPE — shared by ``_attn_seq`` and
    ``_kv_decode``, which spell it out twice in the reference."""
    q, k, v = _proj(h, p.wq), _proj(h, p.wk), _proj(h, p.wv)
    if p.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    if cfg.pos_embedding == "rope":
        q = L.apply_rope(q, positions, base=cfg.rope_base,
                         fraction=cfg.rope_fraction)
        k = L.apply_rope(k, positions, base=cfg.rope_base,
                         fraction=cfg.rope_fraction)
    return q, k, v


def _attn_seq(p: Attention, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0, kv_override=None):
    """x: (B, S, D) -> (out, (k, v)).  ``kv_override``: the (k, v) of a
    cross-attention source, taken as given: no k/v projection and no RoPE
    (on q either), as the reference."""
    if kv_override is None:
        q, k, v = _qkv(p, x, cfg, positions)
    else:
        q = _proj(x, p.wq)
        if p.qkv_bias:
            q = q + p.bq.to(q.dtype)
        k, v = kv_override
    o = attn.flash_attention(q, k, v, causal=causal, window=window,
                             kv_chunk=cfg.attn_chunk,
                             causal_skip=cfg.causal_skip)
    return _out_proj(o, p.wo), (k, v)


def _mlp_apply(mp: Mlp, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_act == "gelu":
        return L.gelu_mlp(x, mp.w_in, mp.b_in, mp.w_out, mp.b_out)
    return L.swiglu(x, mp.w_gate, mp.w_up, mp.w_down)


def _ffn_seq(lp: DenseBlock, x: torch.Tensor, cfg: ArchConfig):
    """(FFN output, aux loss): the MLP and 0.0, or the MoE layer (capacity
    factor ``n_experts`` when S == 1, so decode never drops) plus the
    shared experts, added in x's dtype, and its aux loss."""
    if cfg.family == "moe":
        m = lp.moe
        factor = (float(cfg.n_experts) if x.shape[1] == 1
                  else cfg.moe_capacity_factor)
        y, aux = moe_lib.moe_ffn(x, m.we_gate, m.we_up, m.we_down, m.router,
                                 top_k=cfg.experts_per_token,
                                 capacity_factor=factor)
        if m.shared is not None:
            y = y + _mlp_apply(m.shared, x, cfg)
        return y, aux
    return _mlp_apply(lp.mlp, x, cfg), 0.0


def _dense_block_seq(lp: DenseBlock, x: torch.Tensor, cfg: ArchConfig,
                     positions: torch.Tensor, *, causal: bool = True,
                     window: int = 0, cross_kv=None):
    """Pre-norm attention and FFN residuals -> (x, (k, v), aux); with
    ``cross_kv`` (the encoder's (k, v) for this layer) a non-causal
    cross-attention residual between them."""
    h, kv = _attn_seq(lp.attn, _apply_norm(lp.ln1, x, cfg), cfg, positions,
                      causal=causal, window=window)
    x = x + h
    if cross_kv is not None:
        hx, _ = _attn_seq(lp.xattn, _apply_norm(lp.lnx, x, cfg), cfg,
                          positions, causal=False, kv_override=cross_kv)
        x = x + hx
    f, aux = _ffn_seq(lp, _apply_norm(lp.ln2, x, cfg), cfg)
    return x + f, kv, aux


def _mamba_in(lp: MambaBlock, x: torch.Tensor, cfg: ArchConfig):
    """(z, x, B, C (B, S, ·) in x's dtype, dt (B, S, H) float32) of the
    normed input: the five projections and ``softplus(x·wdt + dt_bias)``."""
    h = _apply_norm(lp.norm, x, cfg)
    dt = L.softplus((h @ lp.wdt).float() + lp.dt_bias)
    return h @ lp.wz, h @ lp.wx, h @ lp.wB, h @ lp.wC, dt


def _mamba_out(lp: MambaBlock, x: torch.Tensor, y: torch.Tensor,
               xh: torch.Tensor, z: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """The residual ``x + wo(out_norm((y + Dskip·xh) · silu(z)))``, y and
    xh (..., H, P), rounded to x's dtype where the reference rounds."""
    y = (y.float() + lp.Dskip[:, None] * xh.float()).to(x.dtype)
    y = y.reshape(z.shape) * L.silu(z.float()).to(x.dtype)
    y = L.rms_norm(y, lp.out_norm.w, cfg.norm_eps)
    return x + y @ lp.wo


def _mamba_block_seq(lp: MambaBlock, x: torch.Tensor, cfg: ArchConfig):
    """x (B, S, D) -> (x, (final SSD state (B, H, P, N) float32, conv tail
    (B, W-1, d_inner))): the reference's ``_mamba_block_seq`` and the layer
    body of its ``_ssm_prefill`` in one."""
    z, xr, Bm, Cm, dt = _mamba_in(lp, x, cfg)
    xr, tail = ssm_lib.causal_conv1d(xr, lp.conv_x, lp.conv_b)
    xr = L.silu(xr.float()).to(x.dtype)
    Bsz, S, _ = x.shape
    xh = xr.reshape(Bsz, S, cfg.ssm_heads, cfg.ssm_head_dim)
    y, state = ssm_lib.ssd_chunked(xh, dt, -torch.exp(lp.A_log), Bm, Cm,
                                   chunk=cfg.ssd_chunk)
    return _mamba_out(lp, x, y, xh, z, cfg), (state, tail)


def _mamba_block_step(lp: MambaBlock, x: torch.Tensor, state: torch.Tensor,
                      tail: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One token x (B, 1, D) through a layer; writes the layer's new SSD
    state and conv tail into ``state`` and ``tail`` (cache views)."""
    z, xr, Bm, Cm, dt = _mamba_in(lp, x, cfg)
    xr, new_tail = ssm_lib.causal_conv1d(xr, lp.conv_x, lp.conv_b, tail)
    xr = L.silu(xr.float()).to(x.dtype)
    xh = xr.reshape(x.shape[0], cfg.ssm_heads, cfg.ssm_head_dim)
    y, new = ssm_lib.ssd_decode_step(state, xh, dt[:, 0],
                                     -torch.exp(lp.A_log), Bm[:, 0], Cm[:, 0])
    state.copy_(new)
    tail.copy_(new_tail)
    return _mamba_out(lp, x, y, xh, z, cfg)


def _rec_in(lp: RecBlock, x: torch.Tensor, cfg: ArchConfig):
    """(x branch, gate) of the normed input, in x's dtype: the gate is the
    tanh GELU of its projection in float32."""
    h = _apply_norm(lp.norm, x, cfg)
    gate = F.gelu((h @ lp.w_gate).float(), approximate="tanh").to(x.dtype)
    return h @ lp.w_x, gate


def _rec_out(lp: RecBlock, x: torch.Tensor, y: torch.Tensor,
             gate: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The two residuals: ``x + w_out(y · gate)``, then its MLP on ln2."""
    x = x + (y * gate) @ lp.w_out
    return x + _mlp_apply(lp.mlp, _apply_norm(lp.ln2, x, cfg), cfg)


def _rec_block_seq(lp: RecBlock, x: torch.Tensor, cfg: ArchConfig):
    """x (B, S, D) -> (x, (final h (B, W) float32, conv tail (B, W-1, W)
    in x's dtype)): the reference's ``_rec_block_seq`` and its prefill's
    ``rec_with_state`` in one."""
    xb, gate = _rec_in(lp, x, cfg)
    xb, tail = ssm_lib.causal_conv1d(xb, lp.conv_w, lp.conv_b)
    y, h = lru_lib.rglru_scan(xb, lp.lam, lp.w_r, lp.b_r, lp.w_i, lp.b_i)
    return _rec_out(lp, x, y, gate, cfg), (h, tail)


def _rec_block_step(lp: RecBlock, x: torch.Tensor, h: torch.Tensor,
                    tail: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One token x (B, 1, D) through a recurrent layer; writes its new h
    and conv tail into ``h`` and ``tail`` (cache views)."""
    xb, gate = _rec_in(lp, x, cfg)
    xb, new_tail = ssm_lib.causal_conv1d(xb, lp.conv_w, lp.conv_b, tail)
    y, new = lru_lib.rglru_step(xb[:, 0], h, lp.lam, lp.w_r, lp.b_r,
                                lp.w_i, lp.b_i)
    h.copy_(new)
    tail.copy_(new_tail)
    return _rec_out(lp, x, y[:, None, :], gate, cfg)


def _attn_block_step(lp: DenseBlock, x: torch.Tensor, kc: torch.Tensor,
                     vc: torch.Tensor, pos: int,
                     cfg: ArchConfig) -> torch.Tensor:
    """One token x (B, 1, D) at position ``pos`` through a local-attention
    layer whose ring buffers ``kc``, ``vc`` (B, window, Hkv, hd) it writes
    at slot ``pos % window``.  As the reference's ``attn_step``: no QKV
    bias and RoPE over the whole head, whatever the config."""
    W = cfg.window
    posv = torch.arange(pos, pos + 1, device=x.device)
    p = lp.attn
    h = _apply_norm(lp.ln1, x, cfg)
    q = L.apply_rope(_proj(h, p.wq), posv, base=cfg.rope_base)
    k = L.apply_rope(_proj(h, p.wk), posv, base=cfg.rope_base)
    slot = pos % W
    kc[:, slot] = k[:, 0]
    vc[:, slot] = _proj(h, p.wv)[:, 0]
    o = attn.decode_attention(q, kc, vc, pos + 1, window=W)
    x = x + _out_proj(o, p.wo)
    f, _ = _ffn_seq(lp, _apply_norm(lp.ln2, x, cfg), cfg)
    return x + f


# ===========================================================================
# backbone
# ===========================================================================

def _embed_inputs(model: "Model", cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor]):
    """(x (B, S, D), loss mask None) from ``batch["tokens"]`` (B, S); for
    vlm the ``patches`` (B, P, frontend_dim) projected by ``patch_proj`` and
    put before the tokens' embeddings (S = P + the tokens).  Audio prompts
    go through ``Model._audio_prefill`` instead.  Inputs and tables are cast to the
    weights' dtype where the reference casts to its ``PDT``: bf16; in a
    float32 copy (``model.float()``) float32, so the copy computes in
    float32 from its inputs on, as the reference does with ``PDT``
    float32."""
    dt = model.embed.dtype
    emb = F.embedding(batch["tokens"], model.embed)
    if cfg.family == "vlm":
        patches = batch["patches"].to(dt) @ model.patch_proj
        emb = torch.cat([patches, emb], dim=1)
    if cfg.pos_embedding == "sinusoidal":
        emb = emb + L.sinusoidal_pos(emb.shape[1], cfg.d_model,
                                     device=emb.device).to(dt)
    return emb, None


# products without a batch dimension: the weight projections (``x @ w``
# reaches the dispatcher as ``mm``); the attention scores, the experts and
# the SSD terms are ``bmm`` over batch dimensions, as in the reference
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of products without a batch dimension, recompute the
    rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(fn, *args, context_fn=ckpt.noop_context_fn):
    """``fn(*args)`` under ``torch.utils.checkpoint`` while autograd
    records (the bodies draw no random numbers, so no RNG state is kept),
    else plainly."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context_fn)


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` rematerialised in the backward pass where the reference wraps
    it in ``jax.checkpoint``: with ``cfg.remat``, saving nothing
    (``remat_policy="full"``) or the products without a batch dimension
    (``"dots"``)."""
    if not cfg.remat:
        return fn
    context_fn = ckpt.noop_context_fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(_checkpoint, fn, context_fn=context_fn)


def _backbone_seq(model: "Model", cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, collect_kv: bool = False):
    """Runs the layers, each (a hybrid model: each group, then each tail
    layer) through ``_maybe_remat``.  Returns (hidden, (k, v) stacked (L,
    B, S, Hkv, hd) or None, the layers' aux losses summed, float32 ());
    ssm and hybrid models return no kv (their prefill keeps its own
    states).  The audio family runs ``_whisper_encode`` and
    ``_whisper_decode_seq`` instead."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        body = _maybe_remat(lambda lp, x: _mamba_block_seq(lp, x, cfg)[0],
                            cfg)
        for lp in model.layers:
            x = body(lp, x)
        return x, None, aux_total
    if cfg.family == "hybrid":
        def gbody(gp, x):
            for _, kind, lp in gp.blocks(cfg):
                x = (_rec_block_seq(lp, x, cfg) if kind == "rec" else
                     _dense_block_seq(lp, x, cfg, positions,
                                      window=cfg.window))[0]
            return x
        gbody = _maybe_remat(gbody, cfg)
        tbody = _maybe_remat(lambda lp, x: _rec_block_seq(lp, x, cfg)[0],
                             cfg)
        for gp in model.groups:
            x = gbody(gp, x)
        for lp in model.tail:
            x = tbody(lp, x)
        return x, None, aux_total

    def body(lp, x):
        x, kv, a = _dense_block_seq(lp, x, cfg, positions)
        return x, (kv if collect_kv else None), a
    body = _maybe_remat(body, cfg)
    kvs = []
    for lp in model.layers:
        x, kv, a = body(lp, x)
        aux_total = aux_total + a
        kvs.append(kv)
    if not collect_kv:
        return x, None, aux_total
    k, v = (torch.stack(t) for t in zip(*kvs))
    return x, (k, v), aux_total


def _whisper_encode(model: "Model", cfg: ArchConfig,
                    frames: torch.Tensor) -> torch.Tensor:
    """The encoder: frames (B, S_enc, D) in the weights' dtype plus the
    sinusoidal table, then the bidirectional ``enc_layers``, each through
    ``_maybe_remat``; no final norm, as the reference."""
    x = frames.to(model.embed.dtype)
    x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model,
                             device=x.device).to(x.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    body = _maybe_remat(lambda lp, x: _dense_block_seq(
        lp, x, cfg, pos, causal=False)[0], cfg)
    for lp in model.enc_layers:
        x = body(lp, x)
    return x


def _whisper_decode_seq(model: "Model", cfg: ArchConfig,
                        tokens: torch.Tensor, enc: torch.Tensor, *,
                        collect_kv: bool = False):
    """The decoder over tokens (B, S) against the encoder's output enc (B,
    S_enc, D): token embeddings plus the sinusoidal table, causal
    self-attention, and per layer cross-attention to ``xk``/``xv``, enc
    projected by ``xattn.wk``/``wv`` (no bias, no positions); each layer,
    its projections of enc included, through ``_maybe_remat``.  Returns
    (x, ((k, v), (xk, xv)) each stacked (L, B, ·, Hkv, hd), or None)."""
    x = F.embedding(tokens, model.embed)
    x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model,
                             device=x.device).to(x.dtype)
    pos = torch.arange(x.shape[1], device=x.device)

    def body(lp, x, enc):
        xkv = (_proj(enc, lp.xattn.wk), _proj(enc, lp.xattn.wv))
        x, kv, _ = _dense_block_seq(lp, x, cfg, pos, cross_kv=xkv)
        return x, ((*kv, *xkv) if collect_kv else None)
    body = _maybe_remat(body, cfg)
    kvs = []
    for lp in model.dec_layers:
        x, kv = body(lp, x, enc)
        kvs.append(kv)
    if not collect_kv:
        return x, None
    k, v, xk, xv = (torch.stack(t) for t in zip(*kvs))
    return x, ((k, v), (xk, xv))


def _hybrid_blocks(model: "Model"):
    """(kind, block, cache key, index) for each layer of a hybrid model in
    order: every group's blocks (key ``b{i}``, index the group), then the
    tail's recurrent layers (key ``tail``)."""
    for g, gp in enumerate(model.groups):
        for i, kind, lp in gp.blocks(model.cfg):
            yield kind, lp, f"b{i}", g
    for t, lp in enumerate(model.tail):
        yield "rec", lp, "tail", t


def _hybrid_state(cache: Cache, key: str, index: int):
    """A layer's two cache views: (h, conv tail) or (k ring, v ring)."""
    pair = cache["tail"] if key == "tail" else cache["groups"][key]
    return pair[0][index], pair[1][index]


def _ring_init(k: torch.Tensor, W: int) -> torch.Tensor:
    """The last W positions of prefill kv (B, S, H, hd) as ring state,
    laid out so that position p occupies slot p mod W (decode's
    convention); zeros after the prompt where S < W."""
    B, S, H, hd = k.shape
    if S <= W:
        pad = torch.zeros((B, W - S, H, hd), dtype=k.dtype, device=k.device)
        return torch.cat([k, pad], dim=1)
    # index j holds position S-W+j; it belongs at slot (j + S) mod W
    return torch.roll(k[:, S - W:], S % W, dims=1)


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, D) @ w (D, V) -> float32 (B, V): bf16 products summed in
    float32 and not rounded back, as the reference's
    ``preferred_element_type=float32``.  On the card that is one cuBLAS call
    (``torch.mm``'s ``out_dtype``); the CPU has no such call, so there the
    inputs are upcast."""
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


class _LogitsMm(torch.autograd.Function):
    """``_logits`` (bf16 products summed in float32, not rounded back) with
    the transpose ``jax.grad`` takes of ``preferred_element_type=float32``:
    the float32 cotangent times the other operand upcast to float32, a
    float32 product, rounded to that operand's dtype.  A function of its
    own, as ``torch.mm``'s ``out_dtype`` on the card has no such
    backward."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(h, w)
        return _logits(h, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, w = ctx.saved_tensors
        gh = gw = None
        if ctx.needs_input_grad[0]:
            gh = (g @ w.float().t()).to(h.dtype)
        if ctx.needs_input_grad[1]:
            gw = (h.float().t() @ g).to(w.dtype)
        return gh, gw


def _chunk_nll(h: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
               w: torch.Tensor, vocab: int) -> torch.Tensor:
    """Σ (logsumexp − gold logit) · mask over one chunk: h (B, c, D), y and
    m (B, c); the logits (B, c, V) float32, padded-vocab columns -1e30.
    The logsumexp is ``jax.nn.logsumexp``'s: the max held constant."""
    B, c, D = h.shape
    logits = _LogitsMm.apply(h.reshape(B * c, D), w).view(B, c, -1)
    if w.shape[-1] > vocab:
        keep = torch.arange(w.shape[-1], device=h.device) < vocab
        logits = torch.where(keep, logits, -1e30)
    mx = logits.amax(dim=-1, keepdim=True).detach()
    lz = torch.log(torch.exp(logits - mx).sum(dim=-1)) + mx[..., 0]
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum((lz - gold) * m)


def lm_loss(model: "Model", cfg: ArchConfig, hidden: torch.Tensor,
            labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked-vocab cross entropy, float32 (): hidden (B, S, D), labels
    (B, S), mask (B, S) or None (all ones).  The reference's chunking: c =
    min(loss_chunk, S) positions a chunk where c divides S, else one chunk;
    each chunk's logits against ``model.lm_head`` exist only inside
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so the
    (B, S, V) logits never do, forward or backward.  The chunks' sums add
    in order and divide by max(Σ mask, 1)."""
    B, S, _ = hidden.shape
    c = min(cfg.loss_chunk, S)
    nc = S // c if S % c == 0 else 1
    c = S // nc
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        tot = tot + _checkpoint(_chunk_nll, hidden[:, sl], labels[:, sl],
                                mask[:, sl], model.lm_head, cfg.vocab)
    return tot / torch.clamp(mask.sum(), min=1.0)


# ===========================================================================
# public API
# ===========================================================================

class Model(nn.Module):
    """A dense, MoE, Mamba-2, RecurrentGemma or VLM decoder's, or a Whisper
    encoder-decoder's, weights on one device and its serving steps.

    ``Model(cfg, device)`` holds zeros (the reference's init for norms and
    biases) and the SSM and RG-LRU layers' constants; ``init(generator)``
    draws the matrices, ``interop.lm_params`` loads the reference's.
    ``device=None`` means the card and raises where there is none.  The
    layers are ``layers``, or for the hybrid family ``groups`` (of
    ``HybridGroup``) and ``tail`` (``RecBlock``s, empty when the pattern
    divides ``n_layers``), or for audio ``enc_layers`` (``enc_layers``
    blocks) and ``dec_layers`` (``n_layers`` blocks with cross-attention);
    vlm adds ``patch_proj`` (frontend_dim, D) bf16.
    """

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(cfg.family)
        dev = resolve_device(device)
        self.cfg = cfg
        Vp, D = cfg.vocab_padded, cfg.d_model
        self.embed = _param(torch.zeros((Vp, D), dtype=PDT, device=dev))
        self.lm_head = _param(torch.zeros((D, Vp), dtype=PDT, device=dev))
        self.final_norm = Norm(cfg, D, dev)
        if cfg.family == "hybrid":
            G, T = _hybrid_counts(cfg)
            self.groups = nn.ModuleList(HybridGroup(cfg, dev)
                                        for _ in range(G))
            self.tail = nn.ModuleList(RecBlock(cfg, dev) for _ in range(T))
            return
        if cfg.family == "audio":
            self.enc_layers = nn.ModuleList(DenseBlock(cfg, dev)
                                            for _ in range(cfg.enc_layers))
            self.dec_layers = nn.ModuleList(DenseBlock(cfg, dev, cross=True)
                                            for _ in range(cfg.n_layers))
            return
        if cfg.family == "vlm":
            self.patch_proj = _param(torch.zeros(
                (cfg.frontend_dim, D), dtype=PDT, device=dev))
        block = MambaBlock if cfg.family == "ssm" else DenseBlock
        self.layers = nn.ModuleList(block(cfg, dev)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init(self, generator: torch.Generator) -> "Model":
        """Draws the embedding, ``lm_head``, every layer's matrices (audio:
        the encoder's, then the decoder's) and a VLM's ``patch_proj`` from
        ``generator`` (on this model's device), in that order, with the
        reference's distributions; norms, biases and the SSM and RG-LRU
        constants stay as constructed."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        self.embed.copy_(L.embed_init(generator, cfg.vocab_padded,
                                      cfg.d_model))
        self.lm_head.copy_(L.dense_init(generator, cfg.d_model,
                                        (cfg.vocab_padded,), dtype=PDT))
        if cfg.family == "hybrid":
            blocks = [lp for _, lp, _, _ in _hybrid_blocks(self)]
        elif cfg.family == "audio":
            blocks = [*self.enc_layers, *self.dec_layers]
        else:
            blocks = self.layers
        for lp in blocks:
            lp.init(generator, cfg)
        if cfg.family == "vlm":
            self.patch_proj.copy_(L.dense_init(
                generator, cfg.frontend_dim, (cfg.d_model,), dtype=PDT))
        return self

    # ----- training -----
    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The training loss, float32 (): ``lm_loss`` of the final-normed
        hidden states against ``batch["labels"]`` (B, S).  Audio: the
        encoder over ``frames``, the decoder over ``tokens``, no aux term.
        The rest: ``tokens`` (vlm: after ``patches``, whose positions the
        loss skips) through the layers at positions ``arange(S)``, plus
        0.01 times the MoE layers' aux losses summed."""
        cfg = self.cfg
        if cfg.family == "audio":
            enc = _whisper_encode(self, cfg, batch["frames"])
            x, _ = _whisper_decode_seq(self, cfg, batch["tokens"], enc)
            x = _apply_norm(self.final_norm, x, cfg)
            return lm_loss(self, cfg, x, batch["labels"])
        x, _ = _embed_inputs(self, cfg, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = _backbone_seq(self, cfg, x, positions)
        x = _apply_norm(self.final_norm, x, cfg)
        if cfg.family == "vlm":
            x = x[:, cfg.n_patches:, :]
        return lm_loss(self, cfg, x, batch["labels"]) + 0.01 * aux

    # ----- serving -----
    def _mask_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Padded-vocab columns (at and above ``cfg.vocab``) read -1e30."""
        V = logits.shape[-1]
        if V <= self.cfg.vocab:
            return logits
        keep = torch.arange(V, device=logits.device) < self.cfg.vocab
        return torch.where(keep, logits, -1e30)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """Process the full prompt ``batch["tokens"]`` (B, S) (audio: also
        ``frames`` (B, S_enc, D); vlm: also ``patches`` (B, P,
        frontend_dim), before the tokens); returns (last logits (B, V)
        float32, cache of ``cache_len`` positions; for ssm each layer's
        final SSD state and conv tail, for the hybrid each recurrent layer's
        final h and conv tail and each attention layer's window of k and v
        as a ring, whatever ``cache_len``; for audio also each decoder
        layer's cross-attention ``xk``/``xv`` over the S_enc frames)."""
        cfg = self.cfg
        if cfg.family == "audio":
            x, cache = self._audio_prefill(batch, cache_len)
        elif cfg.family == "ssm":
            x, cache = self._ssm_prefill(_embed_inputs(self, cfg, batch)[0])
        elif cfg.family == "hybrid":
            x, cache = self._hybrid_prefill(
                _embed_inputs(self, cfg, batch)[0])
        else:
            x, _ = _embed_inputs(self, cfg, batch)
            positions = torch.arange(x.shape[1], device=x.device)
            x, (k, v), _ = _backbone_seq(self, cfg, x, positions,
                                         collect_kv=True)
            cache = {"k": _grow(k, cache_len), "v": _grow(v, cache_len),
                     "len": x.shape[1]}
        x = _apply_norm(self.final_norm, x, cfg)
        return self._mask_vocab(_logits(x[:, -1, :], self.lm_head)), cache

    def _audio_prefill(self, batch: Dict[str, torch.Tensor],
                       cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """The encoder over ``batch["frames"]``, then the decoder over
        ``batch["tokens"]``: its self-attention k and v grown to
        ``cache_len`` positions, its cross-attention ``xk``/``xv`` as
        projected (S_enc positions) and ``len`` the tokens' count."""
        cfg = self.cfg
        enc = _whisper_encode(self, cfg, batch["frames"])
        x, ((k, v), (xk, xv)) = _whisper_decode_seq(
            self, cfg, batch["tokens"], enc, collect_kv=True)
        return x, {"k": _grow(k, cache_len), "v": _grow(v, cache_len),
                   "xk": xk, "xv": xv, "len": batch["tokens"].shape[1]}

    def _ssm_prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """The layers over the embedded prompt x (B, S, D), each layer's
        final state and conv tail written into a new cache."""
        cache = self._ssm_cache(x.shape[0], x.dtype)
        for lp, st, tl in zip(self.layers, cache["state"], cache["conv"]):
            x, (state, tail) = _mamba_block_seq(lp, x, self.cfg)
            st.copy_(state)
            tl.copy_(tail)
        cache["len"] = x.shape[1]
        return x, cache

    def _ssm_cache(self, batch_size: int, dtype: torch.dtype) -> Cache:
        cfg = self.cfg
        L_, B = cfg.n_layers, batch_size
        return {"state": torch.zeros((L_, B, cfg.ssm_heads, cfg.ssm_head_dim,
                                      cfg.ssm_state), dtype=torch.float32,
                                     device=self.device),
                "conv": torch.zeros((L_, B, cfg.conv_width - 1,
                                     cfg.d_inner), dtype=dtype,
                                    device=self.device),
                "len": 0}

    def _hybrid_prefill(self, x: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """The layers over the embedded prompt x (B, S, D), each layer's
        state written into a new cache: a recurrent layer's final h and
        conv tail, an attention layer's last ``window`` k and v as a ring
        (``_ring_init``)."""
        cfg = self.cfg
        cache = self._hybrid_cache(x.shape[0], x.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        for kind, lp, key, idx in _hybrid_blocks(self):
            a, b = _hybrid_state(cache, key, idx)
            if kind == "rec":
                x, (h, tail) = _rec_block_seq(lp, x, cfg)
                a.copy_(h)
                b.copy_(tail)
            else:
                x, (k, v), _ = _dense_block_seq(lp, x, cfg, positions,
                                                window=cfg.window)
                a.copy_(_ring_init(k, cfg.window))
                b.copy_(_ring_init(v, cfg.window))
        cache["len"] = x.shape[1]
        return x, cache

    def _hybrid_cache(self, batch_size: int, dtype: torch.dtype) -> Cache:
        """Zeros in the reference's layout: ``groups`` maps ``b{i}`` to (h
        (G, B, W) float32, conv tails (G, B, conv-1, W)) or (k, v) rings
        (G, B, window, Hkv, hd), ``tail`` holds (h, conv tails) of the
        tail layers; tails and rings in ``dtype``."""
        cfg = self.cfg
        B, Wd = batch_size, cfg.lru_width
        G, T = _hybrid_counts(cfg)

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)

        def rec(n):
            return (zeros(n, B, Wd, dt=torch.float32),
                    zeros(n, B, cfg.conv_width - 1, Wd))
        groups = {f"b{i}": rec(G) if kind == "rec" else tuple(
            zeros(G, B, cfg.window, cfg.n_kv_heads, cfg.head_dim)
            for _ in range(2)) for i, kind in enumerate(cfg.block_pattern)}
        cache = {"groups": groups, "len": 0}
        if T:
            cache["tail"] = rec(T)
        return cache

    def init_cache(self, batch_size: int, cache_len: int) -> Cache:
        """Zero-initialised cache; k and v are separate tensors, since the
        port's decode writes into them.  For ssm: the SSD states (L, B, H,
        P, N) float32 and conv tails (L, B, W-1, d_inner) bf16; for the
        hybrid ``_hybrid_cache``'s in bf16; both whatever ``cache_len``.
        For audio also ``xk`` and ``xv``, sized ``cache_len`` (not the
        encoder's length), as the reference's."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self._ssm_cache(batch_size, PDT)
        if cfg.family == "hybrid":
            return self._hybrid_cache(batch_size, PDT)
        kv = torch.zeros((cfg.n_layers, batch_size, cache_len,
                          cfg.n_kv_heads, cfg.head_dim), dtype=PDT,
                         device=self.device)
        cache = {"k": kv, "v": kv.clone(), "len": 0}
        if cfg.family == "audio":
            cache["xk"], cache["xv"] = kv.clone(), kv.clone()
        return cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor,
                    cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) -> (logits (B, V) float32, cache advanced by one
        position).  Reads nothing back from the device."""
        cfg = self.cfg
        pos = cache["len"]
        x = F.embedding(tokens, self.embed)
        if cfg.pos_embedding == "sinusoidal":
            table = L.sinusoidal_pos(cache_size_of(cache, cfg), cfg.d_model,
                                     device=x.device)
            x = x + table[pos][None, None, :].to(x.dtype)
        if cfg.family == "ssm":
            x, cache = self._ssm_decode(x, cache)
        elif cfg.family == "hybrid":
            x, cache = self._hybrid_decode(x, cache, pos)
        else:
            x, cache = self._kv_decode(x, cache, pos)
        x = _apply_norm(self.final_norm, x, cfg)
        return self._mask_vocab(_logits(x[:, 0], self.lm_head)), cache

    def _kv_decode(self, x: torch.Tensor, cache: Cache, pos: int):
        """Self-attention writes position ``pos`` of each layer's k and v
        in place; a Whisper decoder layer then attends to all of its
        ``xk``/``xv`` (``xk.shape[1]`` slots, as the reference)."""
        cfg = self.cfg
        audio = cfg.family == "audio"
        posv = torch.arange(pos, pos + 1, device=x.device)
        layers = self.dec_layers if audio else self.layers
        cross = zip(cache["xk"], cache["xv"]) if audio \
            else [(None, None)] * len(layers)
        for lp, kc, vc, (xk, xv) in zip(layers, cache["k"], cache["v"],
                                        cross):
            q, k, v = _qkv(lp.attn, _apply_norm(lp.ln1, x, cfg), cfg, posv)
            kc[:, pos] = k[:, 0]
            vc[:, pos] = v[:, 0]
            o = attn.decode_attention(q, kc, vc, pos + 1)
            x = x + _out_proj(o, lp.attn.wo)
            if audio:
                qx = _proj(_apply_norm(lp.lnx, x, cfg), lp.xattn.wq)
                ox = attn.decode_attention(qx, xk, xv, xk.shape[1])
                x = x + _out_proj(ox, lp.xattn.wo)
            f, _ = _ffn_seq(lp, _apply_norm(lp.ln2, x, cfg), cfg)
            x = x + f
        return x, {**cache, "len": pos + 1}

    def _ssm_decode(self, x: torch.Tensor, cache: Cache):
        for lp, st, tl in zip(self.layers, cache["state"], cache["conv"]):
            x = _mamba_block_step(lp, x, st, tl, self.cfg)
        return x, {"state": cache["state"], "conv": cache["conv"],
                   "len": cache["len"] + 1}

    def _hybrid_decode(self, x: torch.Tensor, cache: Cache, pos: int):
        for kind, lp, key, idx in _hybrid_blocks(self):
            a, b = _hybrid_state(cache, key, idx)
            if kind == "rec":
                x = _rec_block_step(lp, x, a, b, self.cfg)
            else:
                x = _attn_block_step(lp, x, a, b, pos, self.cfg)
        return x, {**cache, "len": pos + 1}


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Model:
    """A ``Model`` on ``device`` (default the card) with its weights drawn
    from ``generator``, which must live on that device."""
    return Model(cfg, device).init(generator)


def _grow(kv: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Pad prefill kv (L, B, S, H, hd) out to the full cache length."""
    L_, B, S, H, hd = kv.shape
    if S >= cache_len:
        return kv[:, :, :cache_len]
    pad = torch.zeros((L_, B, cache_len - S, H, hd), dtype=kv.dtype,
                      device=kv.device)
    return torch.cat([kv, pad], dim=2)


def cache_size_of(cache: Cache, cfg: ArchConfig) -> int:
    if "k" in cache:
        return cache["k"].shape[2]
    return 8192


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """A ``Model`` of zeros on ``device`` (default the card)."""
    return Model(cfg, device)
