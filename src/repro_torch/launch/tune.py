"""ACTS over the port: ``python -m repro_torch.launch.tune``.

Counterpart of ``repro.launch.tune``.  The ported modes:

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
* ``--joint`` — cross-system co-tuning: the serve engine's knobs AND the
  dense decode kernel's launch config as ONE ``CompositeSUT`` under one
  budget (``subspace_rr`` by default).  The default scorer is the
  analytic co-deployment surrogate (``repro_torch.serve.space``), which
  never touches a card: its winners persist under ``model-sm90``.
  ``--real`` instead wall-clocks the LIVE system on ``--device`` every
  trial — the real ``ServeEngine`` rebuilt and timed under each
  candidate config, the real train step rebuilt and timed, train-step
  knobs joining the composite — on ``reduced(cfg)`` at ``max_seq =
  min(seq_len, 128)``, as the reference does.  Its winners persist under
  the device's backend (``cuda-sm90`` on an H100, ``model-sm90`` on the
  CPU).  Every winner lands in one cache: the kernel config under the
  decode shape, the serve knobs as a serve-config entry at the mesh key
  ``1dev``, and (``--real``) the train knobs as a train-step entry
  (``persist_joint_winners``).

``--max-devices`` above 1 (ROADMAP queue 1: multi-device), ``--probe``
and the default dry-run mode (ROADMAP queue 1: dry-run and roofline) are
not ported yet and raise.

Examples:
  python -m repro_torch.launch.tune --arch gemma-7b --shape train_4k \\
      --tune-kernels --kernel-budget 8
  python -m repro_torch.launch.tune --arch gemma-7b --shape train_4k \\
      --joint --budget 24
  python -m repro_torch.launch.tune --arch gemma-7b --shape train_4k \\
      --joint --real --budget 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

from repro_torch.configs import SHAPES, get_config, list_configs

__all__ = ["joint_winner_keys", "main", "persist_joint_winners"]


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


def joint_winner_keys(sut, parts) -> Dict[str, Any]:
    """The cache keys of a joint run's winners, read off the composite
    (``parts``: the best config split by member): the decode kernel's
    dims (the live kernel member's own shape, at the default batch it
    scored every candidate at; on the surrogate, the tuned serve batch),
    the serve dims (the serving window and the model's heads) and, with
    a train member, the train dims (the serve dims at the train step's
    sequence length and global batch); and the dtype of every entry."""
    kernel, serve = sut.members["kernel"], sut.members["serve"]
    if hasattr(serve, "base"):  # the live engine
        cfg = serve.model.cfg
        serve_dims = {"S": serve.base.max_seq, "H": cfg.n_heads,
                      "KV": cfg.n_kv_heads, "D": cfg.head_dim_}
        kernel_dims = dict(kernel.dims)
    else:  # the surrogate: a bare space, its params on the scalarizer
        p = sut.scalarize.params
        serve_dims = {"S": p.max_seq, "H": p.heads, "KV": p.kv_heads,
                      "D": p.head_dim}
        kernel_dims = p.decode_dims(parts["serve"]["max_batch"])
    train = sut.members.get("train")
    train_dims = None if train is None else dict(
        serve_dims, S=train.seq_len, B=train.global_batch)
    return {"dtype": kernel.dtype, "kernel": kernel_dims,
            "serve": serve_dims, "train": train_dims}


def persist_joint_winners(report, sut, *, backend: str, mode: str,
                          cache=None) -> Dict[str, Any]:
    """Persist a joint run's winners in ONE cache under ``backend``, at
    the keys ``joint_winner_keys`` reads off the composite: the decode
    kernel's config, the serve knobs as the serve-config entry at the
    single-device mesh key, and the train knobs (when the composite has
    a train member) as the train-step entry.  Returns those keys."""
    from repro_torch import autotune

    parts = sut.space().split(report.best_config)
    keys = joint_winner_keys(sut, parts)
    dtype = keys["dtype"]
    cache = autotune.default_cache() if cache is None else cache
    meta = {"mode": mode, "n_tests": report.n_tests}
    value = report.best_metric.value
    cache.put("decode_attention", autotune.shape_sig(keys["kernel"]),
              dtype, backend, parts["kernel"], value, meta=meta)
    autotune.put_serve_config(
        keys["serve"], dtype, parts["serve"], value, cache=cache,
        backend=backend, meta=meta, mesh=autotune.mesh_sig(None))
    if "train" in parts:
        autotune.put_train_config(
            keys["train"], dtype, parts["train"], value, cache=cache,
            backend=backend, meta=meta)
    return keys


def _joint_main(args) -> int:
    """--joint: serve knobs + decode kernel config (+ train-step knobs in
    --real mode) co-tuned as one SUT under one budget."""
    from repro_torch import autotune
    from repro_torch.core.tuner import Tuner

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]

    if args.real:
        from repro_torch.configs import reduced
        from repro_torch.serve.space import make_live_cotune_sut

        # every trial rebuilds the REAL serve engine and the REAL train
        # step under the candidate knobs and times them on the device
        sut = make_live_cotune_sut(reduced(cfg),
                                   max_seq=min(shape.seq_len, 128),
                                   seed=args.seed,
                                   repeats=args.real_repeats,
                                   max_devices=args.max_devices,
                                   device=args.device)
        mode = "joint-real"
        backend = autotune.backend_name(args.device)
    else:
        from repro_torch.serve.space import CotuneParams, make_cotune_sut

        if not args.surrogate:
            print("[joint] scoring on the analytic co-deployment surrogate "
                  "(pass --real to wall-clock the live engine + train "
                  "step instead, or --surrogate to silence this note)")
        params = CotuneParams.from_model(cfg,
                                         max_seq=min(shape.seq_len, 32768))
        sut = make_cotune_sut(params, max_devices=args.max_devices)
        mode = "joint-surrogate"
        backend = autotune.backend_name("cpu")  # the cost model's key

    space = sut.space()
    rep = Tuner(space, sut, budget=args.budget, optimizer=args.optimizer,
                seed=args.seed, verbose=True).run()
    parts = space.split(rep.best_config)
    keys = persist_joint_winners(rep, sut, backend=backend, mode=mode)

    os.makedirs(args.out_dir, exist_ok=True)
    tag = f"joint_{args.arch}_{args.shape}" + ("_real" if args.real else "")
    out = json.loads(rep.to_json())
    out["persisted"] = dict(keys, backend=backend)  # where to read back
    with open(os.path.join(args.out_dir, f"{tag}.json"), "w") as f:
        json.dump(out, f, indent=2)

    d, b = rep.default_metric, rep.best_metric
    print("\n=== ACTS joint co-tuning result ===")
    scorer = ("live wall-clock on " + args.device if args.real
              else "surrogate")
    print(f"cell: {args.arch} × {args.shape} ({scorer}, "
          f"optimizer={args.optimizer}, backend={backend})")
    print(f"default: {d.value:.1f} tok/s  (all-member defaults)")
    print(f"best:    {b.value:.1f} tok/s  "
          f"latency={b.metrics.get('latency_s', float('nan')):.3f}s")
    print(f"improvement: {rep.improvement:.2f}x in {rep.n_tests} tests "
          f"({rep.wall_seconds:.1f}s wall)")
    print(f"serve knobs:   {parts['serve']}")
    print(f"kernel config: {parts['kernel']}")
    if "train" in parts:
        print(f"train knobs:   {parts['train']}")
    print(f"persisted to {autotune.default_cache().path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--budget", type=int, default=24)
    ap.add_argument("--optimizer", default=None,
                    help="optimizer name (default: rrs; subspace_rr "
                         "for --joint)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tune-kernels", action="store_true",
                    help="ACTS over the cell's CUDA kernel launch configs; "
                         "winners persist in the autotune cache")
    ap.add_argument("--kernel-budget", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (time each test on the card) or cpu (the "
                         "Hopper cost model for --tune-kernels; the live "
                         "system on the CPU for --joint --real)")
    ap.add_argument("--joint", action="store_true",
                    help="co-tune serve-engine knobs + the decode kernel's "
                         "launch config as one SUT (CompositeSpace, shared "
                         "budget)")
    ap.add_argument("--surrogate", action="store_true",
                    help="with --joint: score on the analytic co-deployment "
                         "surrogate (the default; the flag silences the "
                         "which-scorer note)")
    ap.add_argument("--real", action="store_true",
                    help="with --joint: wall-clock the LIVE system on "
                         "--device every trial (the real ServeEngine and "
                         "train step rebuilt under each candidate, the "
                         "reduced model); adds train-step knobs to the "
                         "composite and persists their winner too")
    ap.add_argument("--max-devices", type=int, default=1,
                    help="with --joint: 1 (above 1 is ROADMAP queue 1: "
                         "multi-device, not ported yet)")
    ap.add_argument("--real-repeats", type=int, default=3,
                    help="with --joint --real: timed repeats per trial "
                         "(median taken)")
    ap.add_argument("--out-dir", default="results/tune")
    ap.add_argument("--probe", default=None,
                    help="not ported yet (ROADMAP queue 1: dry-run and "
                         "roofline)")
    args = ap.parse_args(argv)
    if args.optimizer is None:
        args.optimizer = "subspace_rr" if args.joint else "rrs"
    if args.real and not args.joint:
        ap.error("--real only applies to --joint (live co-tuning)")
    if args.real and args.surrogate:
        ap.error("--surrogate and --real are mutually exclusive joint "
                 "scorers")
    if args.max_devices > 1:
        raise NotImplementedError(
            f"--max-devices {args.max_devices}: the sharding subspace "
            "needs ROADMAP queue 1: multi-device, which is not ported yet")
    if args.joint:
        return _joint_main(args)
    if args.probe is not None:
        raise NotImplementedError(
            "--probe needs ROADMAP queue 1: dry-run and roofline, which "
            "is not ported yet")
    if not args.tune_kernels:
        raise NotImplementedError(
            "the default dry-run tuning mode needs ROADMAP queue 1: dry-run "
            "and roofline, which is not ported yet; pass --tune-kernels "
            "or --joint")

    from repro_torch import autotune

    results = tune_kernels(args.arch, args.shape, args.kernel_budget,
                           seed=args.seed, optimizer=args.optimizer,
                           device=args.device)
    print(json.dumps({"cache": autotune.default_cache().path,
                      "entries": results}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
