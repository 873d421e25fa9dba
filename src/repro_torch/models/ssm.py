"""Mamba-2 SSD (state-space duality) layer, chunked matmul form.

Counterpart of ``repro.models.ssm``, function for function (Dao & Gu 2024,
arXiv:2405.21060, "minimal SSD"): the sequence is split into chunks of
length Q; the intra-chunk terms are dense products and the inter-chunk term
carries a (H, P, N) state from chunk to chunk.  One B/C group, a scalar A a
head.  Recurrences and products run in float32; outputs are cast to the
input's dtype where the reference casts them.

What is PyTorch idiom here rather than a copy:
- the reference's ``lax.scan`` over chunks is a Python loop;
- each three-operand einsum is spelled as the pairwise contraction XLA's
  optimal path takes (the elementwise factor first where it keeps the
  intermediate small), so no broadcast materialises a larger tensor than
  the (B, nc, H, Q, Q) decay matrix, which is built in place (its product
  with the scores out of place while autograd records, for training).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class SSMState(NamedTuple):
    state: torch.Tensor  # (B, H, P, N) float32
    conv: torch.Tensor   # (B, W-1, C) conv tail (C = conv channels)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) with out[i, j] = sum_{j<m<=i} x[m], -inf
    above the diagonal: differences of one cumsum, as the reference."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return d.masked_fill_(~keep, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.

    x:  (B, S, H, P) inputs; dt: (B, S, H) > 0 step sizes;
    A:  (H,) < 0 decay rates; Bm, Cm: (B, S, N) input/output projections.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        # pad to a chunk multiple with dt=0 steps (identity transitions,
        # zero input contribution), then drop the padded outputs
        pad = Q - S % Q
        y, final = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)),
            chunk=Q, init_state=init_state)
        return y[:, :S], final
    nc = S // Q

    xf = x.float() * dt[..., None].float()
    dA = dt.float() * A.float()                                # (B, S, H)

    # chunked views
    xc = xf.reshape(Bsz, nc, Q, H, P)
    dAc = dA.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2)       # (B, nc, H, Q)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)

    # intra-chunk (diagonal) term: "bchqk,bcqk,bckhp->bcqhp"
    Lm = segsum(dAc).exp_()                                    # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)           # (B,nc,Q,Q)
    # in place unless autograd records (it keeps exp's output)
    Lm = (Lm * scores[:, :, None] if torch.is_grad_enabled()
          else Lm.mul_(scores[:, :, None]))
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", Lm, xc)
    del Lm

    # chunk -> state contribution: "bcqn,bchq,bcqhp->bchpn"
    dA_cum = torch.cumsum(dAc, dim=-1)                         # (B,nc,H,Q)
    dA_tot = dA_cum[..., -1:]                                  # (B,nc,H,1)
    decay_out = torch.exp(dA_tot - dA_cum)                     # (B,nc,H,Q)
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                          xc * decay_out.permute(0, 1, 3, 2)[..., None])

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_tot[..., 0])                    # (B,nc,H)
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev_states = torch.empty_like(states)                     # (B,nc,H,P,N)
    for c in range(nc):
        prev_states[:, c] = s
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    del states

    # state -> output: "bcqn,bchq,bchpn->bcqhp"
    decay_in = torch.exp(dA_cum)                               # (B,nc,H,Q)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) \
        * decay_in.permute(0, 1, 3, 2)[..., None]

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y.to(x.dtype), s


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update. state: (B, H, P, N); x: (B, H, P); dt: (B, H);
    Bm/Cm: (B, N).  Returns (y (B, H, P) in x's dtype, new state float32)."""
    dA = torch.exp(dt.float() * A.float())                     # (B, H)
    xdt = x.float() * dt[..., None].float()
    upd = xdt[..., None] * Bm.float()[:, None, None, :]        # "bhp,bn->bhpn"
    new = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new, Cm.float())
    return y.to(x.dtype), new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  tail: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C); w: (W, C); tail: (B, W-1, C).

    Returns (y (B, S, C), new tail: the last W-1 rows of the tail-padded
    input).  Taps accumulate in float32 in order 0..W-1, then the bias;
    the activation (silu) is the caller's."""
    B, S, C = x.shape
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)                           # (B, S+W-1, C)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, i: i + S].float() * w[i].float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype), xp[:, S:].clone()
