"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the port's paged continuous-batching engine on ``--device``
(default ``cuda``; raises without a card unless ``--device cpu`` is
given), with the reduced config of the named architecture and random
weights from ``--seed``, as the reference launcher ``repro.launch.serve``
does.  ``--schedule``, ``--page-policy``, ``--temperature``,
``--mixed``, ``--drift`` and the online retuner's ``--retune``,
``--retune-threshold`` and ``--retune-budget`` are the reference's flags,
with its trace generator and printout; ``--runtime`` and ``--mesh`` come
with later slices (ROADMAP queue 1: dense layout and wave runtime;
multi-device).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import PAGE_POLICIES, SCHEDULES

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-layout", choices=("paged",), default="paged",
                    help="KV layout (only the paged pool is ported)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="KV pool size in 16-token pages (bounds how many "
                         "requests stay resident)")
    ap.add_argument("--schedule", choices=SCHEDULES, default="fifo")
    ap.add_argument("--page-policy", choices=PAGE_POLICIES,
                    default="reserve",
                    help="KV reservation policy: worst-case up-front "
                         "(reserve) or prompt-only + on-demand growth with "
                         "recompute preemption (on_demand)")
    ap.add_argument("--prefill-chunk", type=int, default=512)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-length workload: prompt lengths in "
                         "[2, prompt-len], generation lengths in "
                         "[1, max-new]")
    ap.add_argument("--retune", action="store_true",
                    help="online workload-aware retuning: fingerprint the "
                         "live request window, detect drift from the "
                         "deployed knobs' tuned signature and swap in a "
                         "warm-started retune mid-run (see "
                         "repro_torch.serve.workload)")
    ap.add_argument("--retune-threshold", type=float, default=0.25,
                    help="fingerprint distance that triggers a retune")
    ap.add_argument("--retune-budget", type=int, default=16,
                    help="surrogate tests per retune")
    ap.add_argument("--drift", action="store_true",
                    help="with --mixed: the second half of the requests "
                         "shifts to short-tail shared-prefix prompts, so "
                         "--retune has a drift to catch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    engine = ServeEngine(model, params, ServeConfig(
        max_seq=args.prompt_len + args.max_new + 8,
        batch_slots=args.batch_slots, temperature=args.temperature,
        seed=args.seed, kv_layout=args.kv_layout,
        kv_cache_pages=args.kv_pages, schedule=args.schedule,
        page_policy=args.page_policy, prefill_chunk=args.prefill_chunk,
        retune=args.retune, retune_threshold=args.retune_threshold,
        retune_budget=args.retune_budget), device=args.device)
    rng = np.random.default_rng(args.seed)
    if args.mixed:
        plens = rng.integers(2, args.prompt_len + 1, size=args.requests)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in plens]
        max_new = [int(m) for m in
                   rng.integers(1, args.max_new + 1, size=args.requests)]
        if args.drift:
            # second half: shared-prefix short-tail requests, a workload
            # shift the retuner's fingerprint can see
            half = args.requests // 2
            head = rng.integers(1, cfg.vocab_size,
                                size=max(2, args.prompt_len - 2)).tolist()
            for i in range(half, args.requests):
                prompts[i] = head + rng.integers(
                    1, cfg.vocab_size, size=2).tolist()
                max_new[i] = max(1, args.max_new // 4)
    else:
        prompts = rng.integers(1, cfg.vocab_size,
                               size=(args.requests,
                                     args.prompt_len)).tolist()
        max_new = args.max_new
    res = engine.generate(prompts, max_new)
    print(f"{cfg.name} [continuous/{args.kv_layout}/{args.schedule} on "
          f"{engine.device}]: {args.requests} requests, "
          f"prefill {res.prefill_seconds:.2f}s, "
          f"decode {res.decode_seconds:.2f}s "
          f"({res.decode_tokens_per_sec:.1f} tok/s, {res.steps} steps, "
          f"p50 {res.p50_latency_s:.3f}s, p95 {res.p95_latency_s:.3f}s)")
    a = engine.last_alloc
    print(f"  kv pool: {a.n_groups} groups x {a.group_tokens} tokens, "
          f"high water {a.high_water} groups "
          f"[{args.page_policy}, {res.preemptions} preemptions]")
    if args.retune:
        if not res.retunes:
            print("  retune: no workload shift detected")
        for ev in res.retunes:
            moved = ", ".join(f"{k} {old}->{new}"
                              for k, (old, new) in ev["applied"].items()) \
                or "no knob moved"
            print(f"  retune @step {ev['step']}: drift {ev['distance']:.2f}"
                  f" [{ev['warm_source']}] -> {moved} "
                  f"(accept {ev['measured_accept']:.2f})")
    for i, toks in enumerate(res.tokens[:3]):
        print(f"  req {i}: {toks[:16]}{'...' if len(toks) > 16 else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
