"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the port's paged continuous-batching engine (fifo admission,
worst-case page reservations, greedy decoding) on ``--device`` (default
``cuda``; raises without a card unless ``--device cpu`` is given), with
the reduced config of the named architecture and random weights from
``--seed``, as the reference launcher ``repro.launch.serve`` does.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-layout", choices=("paged",), default="paged",
                    help="KV layout (only the paged pool is ported)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="KV pool size in 16-token pages (bounds how many "
                         "requests stay resident)")
    ap.add_argument("--prefill-chunk", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    engine = ServeEngine(model, params, ServeConfig(
        max_seq=args.prompt_len + args.max_new + 8,
        batch_slots=args.batch_slots, seed=args.seed,
        kv_layout=args.kv_layout, kv_cache_pages=args.kv_pages,
        prefill_chunk=args.prefill_chunk), device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(args.requests, args.prompt_len)).tolist()
    res = engine.generate(prompts, args.max_new)
    print(f"{cfg.name} [continuous/{args.kv_layout}/fifo on "
          f"{engine.device}]: {args.requests} requests, "
          f"prefill {res.prefill_seconds:.2f}s, "
          f"decode {res.decode_seconds:.2f}s "
          f"({res.decode_tokens_per_sec:.1f} tok/s, {res.steps} steps, "
          f"p50 {res.p50_latency_s:.3f}s, p95 {res.p95_latency_s:.3f}s)")
    a = engine.last_alloc
    print(f"  kv pool: {a.n_groups} groups x {a.group_tokens} tokens, "
          f"high water {a.high_water} groups")
    for i, toks in enumerate(res.tokens[:3]):
        print(f"  req {i}: {toks[:16]}{'...' if len(toks) > 16 else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
