"""Shared neural layers: norms, MLPs, RoPE, initialisers.

Counterpart of ``repro.models.layers``, function for function.  The
rounding points are the reference's: norms, GELU and RoPE compute in
float32 and cast back to the input's dtype; SwiGLU's gate product is cast
to the input's dtype before the down projection.  Matmuls on bf16 inputs
return bf16 (float32 sums, one rounding), as XLA's do.  The initialisers
draw from a caller's ``torch.Generator`` on the generator's device, with
the reference's shapes, distributions and fan-in scale.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, in_dim: int,
               out_shape: Sequence[int], scale: float = 1.0,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Truncated-normal fan-in init, stored as (in_dim, *out_shape): a
    standard normal cut at ±2, times ``scale / sqrt(in_dim)``, drawn in
    float32 and cast to ``dtype``."""
    shape = (in_dim,) + tuple(out_shape)
    std = scale / max(in_dim, 1) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(vocab, d) standard normal times ``1/sqrt(d)``."""
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(1.0 / d ** 0.5).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``x / rms(x) * (1 + w)`` in float32 (the weight is stored as an
    offset from 1), cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * w.float() + b.float()
    return out.to(x.dtype)


class _Softplus(torch.autograd.Function):
    """``logaddexp(x, 0)`` and the reference's custom derivative of it,
    ``exp(x − out)`` with +inf read as 0 (autograd of the forward's max
    and abs would give 1, not ½, at x = 0)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, out = ctx.saved_tensors

        def finite(t):
            return torch.where(t == torch.inf, 0.0, t)
        return g * torch.exp(finite(x) - finite(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` turns linear above its threshold),
    with the reference's derivative."""
    return _Softplus.apply(x)


def silu(g: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.silu``: ``g * sigmoid(g)`` with its sigmoid
    ``1 / (1 + exp(-g))``, each op rounded to g's dtype (a fused
    ``torch.sigmoid`` rounds once and moves small outputs by hundreds of
    bf16 ulps after the down projection's cancellation)."""
    return g * (1.0 / (1.0 + torch.exp(-g)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``down(silu(x@gate) * (x@up))``."""
    g = silu(x @ w_gate)
    u = x @ w_up
    return (g * u).to(x.dtype) @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: Optional[torch.Tensor],
             w_out: torch.Tensor, b_out: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """``out(gelu(x@in + b_in)) + b_out`` with the tanh GELU in float32."""
    h = x @ w_in
    if b_in is not None:
        h = h + b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    o = h @ w_out
    if b_out is not None:
        o = (o.float() + b_out).to(x.dtype)
    return o


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """positions (...,) -> (cos, sin) of shape (..., dim//2), float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (base ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               base: float = 10000.0, fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,).

    ``fraction < 1`` rotates only the first ``fraction*hd`` dims
    (ChatGLM-style partial rotary / RoPE-2d: the remaining dims are
    position-independent).  The rotated half-pairs are computed in float32
    and cast back to x's dtype.
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = rope_angles(positions, rot, base)   # (B, S, rot/2)
    cos = cos[..., None, :]                        # (B, S, 1, rot/2)
    sin = sin[..., None, :]
    x1f, x2f = xr[..., : rot // 2].float(), xr[..., rot // 2:].float()
    out = torch.cat([x1f * cos - x2f * sin,
                     x2f * cos + x1f * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def sinusoidal_pos(S: int, d: int, offset: int = 0,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """(S, d) float32 table: sin on even columns, cos on odd, positions
    ``offset .. offset + S - 1``."""
    pos = torch.arange(offset, offset + S, dtype=torch.float32,
                       device=device)[:, None]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv = 1.0 / (10000.0 ** exps)
    ang = pos * inv
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe
