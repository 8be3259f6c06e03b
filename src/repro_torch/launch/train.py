"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant training loop (``repro_torch.train.loop``) on
``--device`` (default ``cuda``; raises without a card unless ``--device
cpu`` is given), as the reference launcher ``repro.launch.train`` does.
Architectures run at their reduced config unless ``--full`` is given.
Execution knobs mirror ``RunKnobs``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.optim import OptimizerConfig
from repro_torch.train import RunKnobs, TrainLoopConfig, train

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none",
                    choices=("none", "dots", "full"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8", "topk"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    loop = TrainLoopConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed, log_every=10,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        opt=OptimizerConfig(learning_rate=args.lr, warmup_steps=10,
                            total_steps=args.steps),
        knobs=RunKnobs(rules_preset="dp", remat=args.remat,
                       microbatches=args.microbatches, loss_chunk=0,
                       compression=args.compression),
    )
    out = train(cfg, loop, device=args.device)
    h = out["history"]
    if not h:  # resumed at the last step: nothing left to run
        print(f"\n{cfg.name} on {args.device}: already at step "
              f"{out['final_step']}")
        return 0
    print(f"\n{cfg.name} on {args.device}: loss {h[0]['loss']:.4f} -> "
          f"{h[-1]['loss']:.4f} in {out['final_step']} steps "
          f"({out['wall_seconds']:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
