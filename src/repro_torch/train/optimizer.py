"""Optimizers over a ``Model``'s named parameters (counterpart of
``repro.train.optimizer``).

AdamW keeps float32 ``m`` and ``v`` a parameter (8 bytes a parameter on
top of the bf16 weights); Adafactor keeps a factored second moment (rows
and columns only) and no first moment, for the configs whose Adam state
would not fit.  Both compute in float32 and round the new parameter to its
dtype, with the reference's warm-up ``min((step + 1) / warmup, 1) · lr``.

What is PyTorch idiom here rather than a copy:
- ``init(params)`` takes ``dict(model.named_parameters())`` and
  ``update(grads, state, params, step)`` a dict of the same names; it
  writes the new parameters and state into the given tensors (the
  reference returns new trees, and its trainer donates the old ones) and
  returns them.  ``step`` may be a 0-d device tensor, so an update reads
  nothing back to the host.
- The reference's leaves are stacked over layers (``layers.attn.wq`` is
  (L, D, Hq, hd)); the port holds one tensor a layer
  (``layers.{i}.attn.wq``).  AdamW is elementwise, so that changes
  nothing.  Adafactor's factoring and its RMS clip depend on the stacked
  leaf, so it stacks each group of port tensors that make one reference
  leaf (``stack_name``): a layer norm's (L, D) weight is factored (r over
  the layers, c over D), and the clip's RMS runs over all the layers of a
  leaf at once.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]

# the stacked subtrees of the reference's parameter tree: a port name
# ``{stack}.{i}.{rest}`` is slice i of the reference leaf ``{stack}.{rest}``
STACKS = ("layers", "groups", "tail", "enc_layers", "dec_layers")


def stack_name(name: str) -> Tuple[str, Optional[int]]:
    """A port parameter's reference leaf (dotted) and its index in that
    leaf's stack: ``layers.3.attn.wq`` -> (``layers.attn.wq``, 3),
    ``groups.0.b2_attn.ln1.w`` -> (``groups.b2_attn.ln1.w``, 0), ``embed``
    -> (``embed``, None)."""
    head, _, rest = name.partition(".")
    if head not in STACKS:
        return name, None
    idx, _, leaf = rest.partition(".")
    return f"{head}.{leaf}", int(idx)


def leaf_groups(names) -> Dict[str, List[str]]:
    """The port names of each reference leaf, in stack order."""
    groups: Dict[str, List[Tuple[Optional[int], str]]] = {}
    for n in names:
        key, i = stack_name(n)
        groups.setdefault(key, []).append((i, n))
    return {k: [n for _, n in sorted(v, key=lambda t: t[0] or 0)]
            for k, v in groups.items()}


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params, object], Tuple[Params, dict]]


def _schedule(step, warmup: int, lr: float, device: torch.device):
    """(step + 1 as float32, the warmed-up learning rate), 0-d float32 on
    ``device``."""
    s1 = torch.as_tensor(step, device=device) + 1
    return s1.float(), torch.clamp(s1 / warmup, max=1.0) * lr


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup: int = 100) -> Optimizer:
    """Adam with decoupled weight decay on every parameter (norms and
    biases too, as the reference) and bias correction at t = step + 1."""

    def init(params: Params) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(grads: Params, state: dict, params: Params, step):
        dev = next(iter(params.values())).device
        t, sf = _schedule(step, warmup, lr, dev)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        for n, p in params.items():
            m, v = state["m"][n], state["v"][n]
            gf = grads[n].float()
            a = torch.mul(gf, 1 - b1)                   # two scratch buffers
            m.mul_(b1).add_(a)                          # b1·m + (1-b1)·g
            v.mul_(b2).add_(torch.mul(gf, 1 - b2, out=a).mul_(gf))
            del gf
            torch.div(v, c2, out=a).sqrt_().add_(eps)   # sqrt(v̂) + eps
            delta = torch.div(m, c1).div_(a)            # m̂ / (sqrt(v̂) + eps)
            pf = p.float()                              # p itself if float32
            delta.add_(torch.mul(pf, weight_decay, out=a)).mul_(sf)
            del a
            p.copy_(pf.sub_(delta))
        return params, state

    return Optimizer(init, update)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip: float = 1.0, warmup: int = 100) -> Optimizer:
    """Factored RMS (Shazeer & Stern 2018), beta1 = 0, per reference leaf
    (see the module's docstring): a leaf of ndim >= 2 keeps ``r`` (its
    shape but the last axis) and ``c`` (but the second last), the rest a
    ``v``; ``beta = 1 - t^-decay``, ``vhat = r·c / mean(r)`` and the update
    clipped by its RMS over the whole leaf.  State is keyed by the
    reference leaf's dotted name."""

    def shapes(params: Params):
        for key, names in leaf_groups(params).items():
            ps = [params[n] for n in names]
            stacked = stack_name(names[0])[1] is not None
            shape = ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
            yield key, names, stacked, shape, ps[0].device

    def init(params: Params) -> dict:
        state = {}
        for key, _, _, shape, dev in shapes(params):
            def zeros(s):
                return torch.zeros(s, dtype=torch.float32, device=dev)
            state[key] = ({"r": zeros(shape[:-1]),
                           "c": zeros(shape[:-2] + shape[-1:])}
                          if len(shape) >= 2 else {"v": zeros(shape)})
        return state

    @torch.no_grad()
    def update(grads: Params, state: dict, params: Params, step):
        dev = next(iter(params.values())).device
        t, sf = _schedule(step, warmup, lr, dev)
        beta = 1.0 - t ** (-decay)
        for key, names, stacked, shape, _ in shapes(params):
            s = state[key]
            gs = [grads[n] for n in names]
            gf = (torch.stack(gs) if stacked else gs[0]).to(torch.float32,
                                                              copy=True)
            g2 = (gf * gf).add_(eps)
            if len(shape) >= 2:
                s["r"].copy_(beta * s["r"] + (1 - beta) * g2.mean(dim=-1))
                s["c"].copy_(beta * s["c"] + (1 - beta) * g2.mean(dim=-2))
                del g2
                rm = s["r"].mean(dim=-1, keepdim=True)
                vhat = (s["r"][..., None] * s["c"][..., None, :]).div_(
                    torch.clamp(rm[..., None], min=eps))
                vhat = vhat.clamp_(min=eps).sqrt_()
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                del g2
                vhat = torch.sqrt(torch.clamp(s["v"], min=eps))
            u = gf.div_(vhat)
            del vhat
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u.div_(torch.clamp(rms / clip, min=1.0))
            ps = [params[n] for n in names]
            pf = (torch.stack(ps) if stacked else ps[0]).float()
            new = pf.sub_(u.mul_(sf))
            for p, row in zip(ps, new if stacked else [new]):
                p.copy_(row)
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)
