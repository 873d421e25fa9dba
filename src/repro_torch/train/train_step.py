"""Training step: loss, gradients, global-norm clip, optimizer update
(counterpart of ``repro.train.train_step``).

What is PyTorch idiom here rather than a copy: the reference's step is a
pure function that ``jax.jit`` compiles and whose ``params`` its trainer
donates; the port's closes over a ``Model``, takes its gradients with
autograd, and writes the new parameters into the model in place, eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.model import Model
from repro_torch.train.optimizer import Optimizer, make_optimizer


def make_train_step(model: Model, opt: Optional[Optimizer] = None
                    ) -> Callable:
    """Returns ``train_step(opt_state, batch, step) -> (opt_state,
    metrics)``: ``model.loss(batch)`` and its gradients, their global norm
    ``sqrt(Σ_leaves Σ g²)`` in float32, each gradient scaled by ``min(1,
    1 / max(norm, 1e-6))`` rounded to its dtype (a clip at norm 1), then
    ``opt.update`` (default: the config's optimizer with its defaults) on
    the model's parameters, in place.  ``metrics`` holds ``loss`` and
    ``grad_norm``, 0-d float32 tensors on the model's device; ``step`` may
    be one too, so a step reads nothing back to the host.  The optimizer's
    state comes from ``opt.init(dict(model.named_parameters()))``.

    Turns on ``requires_grad`` for every parameter of ``model``: draw or
    load its weights (``Model.init``, ``interop.lm_params``) before."""
    opt = opt or make_optimizer(model.cfg.optimizer)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)

    def train_step(opt_state, batch: Dict[str, torch.Tensor], step
                   ) -> Tuple[dict, Dict[str, torch.Tensor]]:
        loss = model.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in grads.values()))
            scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-6), max=1.0)
            for g in grads.values():
                g.mul_(scale.to(g.dtype))
            _, opt_state = opt.update(grads, opt_state, params, step)
        return opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
