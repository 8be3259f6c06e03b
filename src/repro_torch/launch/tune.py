"""ACTS over the port's CUDA kernels: ``python -m repro_torch.launch.tune``.

Counterpart of ``repro.launch.tune``.  The ported mode:

* ``--tune-kernels`` — ACTS over the launch configurations of the cell's
  kernels: flash attention at the cell's sequence length, dense and paged
  decode attention at batch 1 over that length, and RMSNorm over that
  many rows of ``d_model``, at the model's full width and compute dtype.
  Each winner persists in the autotune cache (``$REPRO_AUTOTUNE_CACHE``,
  else ``~/.cache/repro/autotune.json``) under the backend of
  ``--device``: on the card (``cuda``, the default) every test times the
  kernel; ``--device cpu`` scores the Hopper cost model instead.  The
  kernel entry points (``repro_torch.kernels.ops``) and the serve engine
  (``ServeConfig.autotune_kernels``) read the winners back.

``--joint`` (ROADMAP queue 1: co-tuning; ``--real`` also the train
step), ``--probe`` and the default dry-run mode (dry-run and roofline)
are not ported yet and raise.

Example:
  python -m repro_torch.launch.tune --arch gemma-7b --shape train_4k \\
      --tune-kernels --kernel-budget 8
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import SHAPES, get_config, list_configs

__all__ = ["main"]


def tune_kernels(arch: str, shape: str, budget: int, seed: int = 0,
                 optimizer: str = "rrs", device: str = "cuda"):
    """Tune the four kernels of the cell; returns one summary a kernel
    (``repro_torch.autotune.autotune_kernel``'s)."""
    from repro_torch import autotune

    cfg = get_config(arch)
    seq = SHAPES[shape].seq_len
    attn_dims = {"B": 1, "S": seq, "H": cfg.n_heads, "KV": cfg.n_kv_heads,
                 "D": cfg.head_dim_}
    fa_dims = dict(attn_dims, SK=seq)
    rn_dims = {"ROWS": seq, "D": cfg.d_model}
    results = []
    # paged_attention shares the decode signature: its winner seeds the
    # continuous engine's pool layout (pages_per_block -> group size).
    # gla is not tuned here, as the reference's launcher does not tune it
    # (the Mamba2 path passes its chunk explicitly)
    for kernel, dims in (("flash_attention", fa_dims),
                         ("decode_attention", attn_dims),
                         ("paged_attention", attn_dims),
                         ("rmsnorm", rn_dims)):
        res = autotune.autotune_kernel(kernel, dims,
                                       dtype=cfg.compute_dtype,
                                       budget=budget, device=device,
                                       seed=seed, optimizer=optimizer)
        results.append(res)
        print(f"[autotune] {kernel} {res['sig']}: {res['config']} "
              f"({res['mode']}, {res['n_tests']} tests, value "
              f"{res['value']:.6g} s, default {res['default_value']:.6g} s)")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--optimizer", default="rrs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tune-kernels", action="store_true",
                    help="ACTS over the cell's CUDA kernel launch configs; "
                         "winners persist in the autotune cache")
    ap.add_argument("--kernel-budget", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (time each test on the card) or cpu (the "
                         "Hopper cost model)")
    ap.add_argument("--joint", action="store_true",
                    help="not ported yet (ROADMAP queue 1: co-tuning)")
    ap.add_argument("--real", action="store_true",
                    help="not ported yet (ROADMAP queue 1: co-tuning, "
                         "the train step)")
    ap.add_argument("--probe", default=None,
                    help="not ported yet (ROADMAP queue 1: dry-run and "
                         "roofline)")
    args = ap.parse_args(argv)
    if args.joint or args.real:
        raise NotImplementedError(
            "--joint co-tuning needs ROADMAP queue 1: co-tuning (and --real "
            "also the train step), which is not ported yet")
    if args.probe is not None:
        raise NotImplementedError(
            "--probe needs ROADMAP queue 1: dry-run and roofline, which "
            "is not ported yet")
    if not args.tune_kernels:
        raise NotImplementedError(
            "the default dry-run tuning mode needs ROADMAP queue 1: dry-run "
            "and roofline, which is not ported yet; pass --tune-kernels")

    from repro_torch import autotune

    results = tune_kernels(args.arch, args.shape, args.kernel_budget,
                           seed=args.seed, optimizer=args.optimizer,
                           device=args.device)
    print(json.dumps({"cache": autotune.default_cache().path,
                      "entries": results}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
