"""Training launcher (counterpart of ``repro.launch.train``):
deterministic data, checkpoint and restart, on one device.

Fault tolerance: a step's batch is a pure function of (seed, step), and a
checkpoint is atomic and carries the step and the seed, so a crash and a
restart resume at the step boundary with the same data (on the CPU bit
for bit; on the card up to the backward's atomics).  ``--simulate-crash
N`` kills the process at step N (exit code 42) to exercise it.  The
presets ``SMOKE``, ``M100`` and ``scaled_config`` are the reference's, and
``launch/serve.py`` reads them too.

What is PyTorch idiom here rather than a copy: the reference draws a
step's batch from ``jax.random.fold_in(PRNGKey(seed), step)``, whose
draws torch cannot replay; the port seeds a ``torch.Generator`` from a
pure integer function of (seed, step) (``make_batch_fn``), and tests
inject the reference's batches (``batch_fn=``) and parameters
(``model=``).  The model is a ``Model`` trained in place by
``make_train_step``; its checkpoint tree is ``(dict(named_parameters()),
optimizer state)``.  There is no mesh: the port trains on one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b \
      --preset smoke --steps 50 --ckpt-dir /tmp/ckpt [--resume] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.data import token_batch
from repro_torch.models.model import Model, init_params
from repro_torch.obs.syncs import read
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import make_optimizer, make_train_step

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


_M64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: splitmix64's finaliser of
    ``z = (seed · 2^32 + step) mod 2^64``, i.e. ``z ^= z >> 30; z *=
    0xBF58476D1CE4E5B9; z ^= z >> 27; z *= 0x94D049BB133111EB; z ^= z >>
    31`` (products mod 2^64).  Distinct for every step below 2^32 of one
    seed."""
    z = (seed * (1 << 32) + step) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def make_batch_fn(cfg, batch: int, seq: int, seed: int, *,
                  device: DeviceLike = None):
    """(step -> batch), pure, so a restart regenerates the same data: a
    ``torch.Generator`` on ``device`` (default the card) seeded with
    ``step_seed(seed, step)`` draws ``token_batch(batch, seq, vocab)``,
    then for the audio family ``frames`` (batch, seq, d_model) and for the
    vlm family ``patches`` (batch, n_patches, frontend_dim), standard
    normal in bf16; the vlm's tokens and labels are cut to ``seq -
    n_patches``, as the reference's."""
    dev = resolve_device(device)

    def fn(step: int):
        g = torch.Generator(dev).manual_seed(step_seed(seed, step))
        b = token_batch(batch, seq, cfg.vocab, generator=g)
        if cfg.family == "audio":
            b["frames"] = torch.randn((batch, seq, cfg.d_model), generator=g,
                                      device=dev, dtype=torch.bfloat16)
        if cfg.family == "vlm":
            p = cfg.n_patches
            b = {"tokens": b["tokens"][:, : seq - p],
                 "labels": b["labels"][:, : seq - p],
                 "patches": torch.randn((batch, p, cfg.frontend_dim),
                                        generator=g, device=dev,
                                        dtype=torch.bfloat16)}
        return b
    return fn


def train(cfg, *, steps: int, batch: int, seq: int, seed: int = 0,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          resume: bool = False, simulate_crash: int = -1,
          log_every: int = 10, device: DeviceLike = None,
          model: Model | None = None, batch_fn=None):
    """Train ``cfg`` for steps ``0 .. steps - 1`` on one device; returns
    (model, [(step, loss), ...] of the logged steps).

    The model is ``init_params(cfg, Generator(device).manual_seed(seed))``
    on ``device`` (default the card), or ``model`` (then on its device),
    the optimizer ``make_optimizer(cfg.optimizer)`` and the step
    ``make_train_step``.  With ``resume`` and a checkpoint under
    ``ckpt_dir``, the parameters and the optimizer state come from the
    latest one (its seed must be ``seed``) and the loop starts at its
    step.  At step ``simulate_crash`` the process exits with code 42.  The
    loss is read (one counted host read, ``obs.syncs.read``) and printed
    every ``log_every`` steps and at the last; a checkpoint is saved every
    ``ckpt_every`` steps and at the end.  ``batch_fn(step)`` (default
    ``make_batch_fn``) returns the step's batch as tensors on the model's
    device."""
    if model is None:
        dev = resolve_device(device)
        model = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    dev = model.device
    opt = make_optimizer(cfg.optimizer)
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    start = 0

    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        (saved, opt_state), start, extra = ckpt.restore(
            ckpt_dir, (params, opt_state))
        if extra.get("seed", seed) != seed:
            raise ValueError(f"checkpoint seed {extra['seed']}, run seed "
                             f"{seed}")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])
        del saved
        print(f"[train] resumed from step {start}", flush=True)

    step_fn = make_train_step(model, opt)
    batch_fn = batch_fn or make_batch_fn(cfg, batch, seq, seed, device=dev)

    losses = []
    t0 = time.time()
    for s in range(start, steps):
        if s == simulate_crash:
            print(f"[train] simulating crash at step {s}", flush=True)
            os._exit(42)
        opt_state, metrics = step_fn(
            opt_state, batch_fn(s),
            torch.full((), s, dtype=torch.int32, device=dev))
        if s % log_every == 0 or s == steps - 1:
            loss = float(read(metrics["loss"]))
            losses.append((s, loss))
            print(f"[train] step {s:5d} loss {loss:.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt_dir and (s + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, s + 1, (params, opt_state),
                      extra={"seed": seed})
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, (params, opt_state), extra={"seed": seed})
    return model, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "m100", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-crash", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args()

    cfg = scaled_config(args.arch, args.preset)
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      seed=args.seed, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, resume=args.resume,
                      simulate_crash=args.simulate_crash, device=args.device)
    if len(losses) >= 2:
        print(f"[train] loss {losses[0][1]:.4f} -> {losses[-1][1]:.4f}")


if __name__ == "__main__":
    main()
