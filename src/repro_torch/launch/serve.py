"""Serving launcher: batched prefill + autoregressive decode loop.

Counterpart of ``repro.launch.serve``: the same flags and stats, plus
``--device`` (default the card; there is no fallback to the CPU).  Weights
and prompt tokens are drawn from ``torch.Generator``s seeded with
``seed``.  Each decode step runs under ``obs.syncs.sync_counter``, so a
host sync inside it raises on the card; on the card the stats also hold
each step's device milliseconds (CUDA events on the stream between
steps).

Usage (any arch of the registry: dense, MoE, Mamba-2, RecurrentGemma,
Whisper or the VLM, e.g. ``qwen2-moe-a2.7b``, ``grok-1-314b``,
``mamba2-2.7b``, ``recurrentgemma-9b``, ``whisper-base``,
``internvl2-2b``; ``--preset full`` for the published widths):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
      --preset smoke --batch 2 --prompt-len 32 --gen 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --preset smoke --batch 2 --prompt-len 32 --gen 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \\
      --preset smoke --batch 2 --prompt-len 32 --gen 8 --device cpu

As the reference's serve: Whisper gets ``frames`` (batch, prompt_len,
d_model) beside its ``prompt_len`` tokens (stub frame embeddings, one a
prompt position), the VLM ``patches`` (batch, n_patches, frontend_dim)
and ``prompt_len - n_patches`` tokens after them; both are standard
normals in bf16 from their own ``torch.Generator``s.

The cache is whatever the family's ``Model.prefill`` builds (KV of
``prompt_len + gen`` positions, with Whisper's cross-attention k/v over
its frames, Mamba-2's fixed-size SSD states and conv tails, or
RecurrentGemma's RG-LRU states, conv tails and ``window``-slot k/v rings,
fixed-size too); each decode step advances it in place.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.train import scaled_config
from repro_torch.models.model import init_params
from repro_torch.obs.syncs import sync_counter
from repro_torch.train import make_decode_step, make_prefill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int,
                 device: torch.device):
    """The prefill batch of ``serve``: ``tokens`` (batch, prompt_len)
    int32, uniform over the vocabulary; for audio also ``frames`` (batch,
    prompt_len, d_model), for vlm ``patches`` (batch, n_patches,
    frontend_dim) in place of the first ``n_patches`` tokens; the stubs
    standard normals in bf16.  Tokens, frames and patches each come from
    a generator seeded with ``seed``."""
    def gen():
        return torch.Generator(device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen(), device=device).to(
            torch.bfloat16)
    b = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                 generator=gen(), dtype=torch.int32,
                                 device=device)}
    if cfg.family == "audio":
        b["frames"] = normal(batch, prompt_len, cfg.d_model)
    if cfg.family == "vlm":
        P = cfg.n_patches
        if prompt_len <= P:
            raise ValueError(f"prompt_len {prompt_len}: the VLM's prompt "
                             f"holds {P} patches and at least one token")
        b = {"tokens": b["tokens"][:, :prompt_len - P],
             "patches": normal(batch, P, cfg.frontend_dim)}
    return b


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          sample: bool = False, device: DeviceLike = None):
    """Prefill ``batch`` random prompts of ``prompt_len`` positions
    (``prompt_batch``), then decode ``gen - 1`` more tokens a row.
    Returns (tokens (batch, gen) int32 on the device, stats):
    ``prefill_s``, ``decode_s``, ``tok_per_s`` (host clock, the device
    synchronised at both ends),
    ``decode_step_ms`` (per step, CUDA events; None on the CPU) and
    ``decode_host_syncs`` (counted inside the decode steps)."""
    dev = resolve_device(device)
    model = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    cache_len = prompt_len + gen
    prompt = prompt_batch(cfg, batch, prompt_len, seed, dev)
    prefill = make_prefill(model, cache_len)
    decode = make_decode_step(model, sample=sample)
    draws = torch.Generator(dev).manual_seed(seed) if sample else None

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(prompt)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out = [tok]
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(gen)]
              if dev.type == "cuda" else None)
    syncs = 0
    t0 = time.perf_counter()
    if events:
        events[0].record()
    for i in range(gen - 1):
        with sync_counter() as sc:
            tok, logits, cache = decode(tok, cache, draws)
        syncs += sc.syncs
        if events:
            events[i + 1].record()
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    step_ms = ([a.elapsed_time(b) for a, b in zip(events, events[1:])]
               if events else None)
    return torch.cat(out, dim=1), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "decode_step_ms": step_ms, "decode_host_syncs": syncs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    cfg = scaled_config(args.arch, args.preset)
    toks, stats = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, sample=args.sample, device=args.device)
    print(f"[serve] generated {tuple(toks.shape)} stats={stats}")


if __name__ == "__main__":
    main()
