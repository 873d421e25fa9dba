"""End-to-end example of the PyTorch port: train a ~100M-param qwen2-family
model for a few hundred steps with checkpointing (the port of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \
        [--arch qwen2-72b] [--device cpu]

It runs on the card unless ``--device`` says otherwise, resumes from the
latest checkpoint in ``--ckpt-dir`` when there is one, and uses the same
config and launcher as the full-size runs: only the preset differs.
"""
import argparse
import os
import tempfile

from repro_torch.launch.llm_cost import param_counts
from repro_torch.launch.train import scaled_config, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args()

    cfg = scaled_config(args.arch, "m100")
    tot, act = param_counts(cfg)
    print(f"[model] {cfg.name} (m100 preset): {tot/1e6:.0f}M params")
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, ckpt_every=100, resume=True,
                      device=args.device)
    if not losses:              # the latest checkpoint is already at --steps
        print(f"[done] nothing to run (checkpoints in {args.ckpt_dir})")
        return
    print(f"[done] loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f} "
          f"(checkpoints in {args.ckpt_dir})")


if __name__ == "__main__":
    main()
