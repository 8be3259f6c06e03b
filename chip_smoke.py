#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):

1. device   - the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build    - the kernel source under src/repro_torch/kernels/csrc, built
              anew even where a library of it is already built.
3. kernels  - each kernel against its plain PyTorch version on the card,
              at the Gemma-7B decode shape and the CPU tests' shapes, in
              bf16 and f32; timed at the Gemma-7B shape beside its bound,
              the plain version and one PyTorch library call.
4. parity   - a tiny f32 model served on the card and on the CPU from the
              same weights: the greedy tokens must be equal.
5. serve    - Gemma-7B at full width in bf16 (random weights from a seed,
              made on the card) serves 8 requests through the paged
              continuous engine; every decode step must launch the paged
              decode kernel once per layer.

The line before the last is the card line; the line before it the
``{"kernels": [...]}`` line; the last line ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

SEED = 0
DEV = "cuda"
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# the CPU tests' tolerances (the reference kernel tests' TOL)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# full-width self-consistency: decode-path and prefill-path logits differ
# only by bf16 rounding in different kernel orderings; a wrong page, head
# or length in the decode kernel decorrelates them far below this
MIN_LOGIT_CORR = 0.99


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median of ``runs`` single-call CUDA-event timings, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: the paged decode kernel against its plain version
# ---------------------------------------------------------------------------
def paged_case(B, H, KV, D, T, maxg, dtype, lengths=None, seed=0):
    g = torch.Generator(device=DEV).manual_seed(seed)
    G = B * maxg + 1  # group 0 stays unused, as the engine's scratch
    dev = DEV
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((G, T, KV, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((G, T, KV, D), generator=g, device=dev).to(dtype)
    perm = 1 + torch.randperm(G - 1, generator=g, device=dev)
    pt = perm[:B * maxg].reshape(B, maxg).to(torch.int32).contiguous()
    if lengths is None:
        lengths = torch.randint(1, maxg * T + 1, (B,), generator=g,
                                device=dev).tolist()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ln


def compare(case) -> float:
    got = ops.paged_flash_decode(*case)
    want = pa.paged_attention_ref(*case)
    torch.cuda.synchronize()
    tol = TOL[case[0].dtype]
    err = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got.float()).all()), "kernel output not finite")
    ok = bool((err <= tol + tol * want.float().abs()).all())
    check(ok, f"kernel disagrees with plain version: max abs err "
              f"{float(err.max()):.3e} > tol {tol}")
    return float(err.max())


def phase_kernels():
    # the Gemma-7B decode shape of the main path: B=8 slots, 16 heads of
    # 256, 16-token groups, 128 groups (max_seq 2048) per slot
    gemma = dict(B=8, H=16, KV=16, D=256, T=16, maxg=128)
    gemma_lengths = [1, 16, 17, 2048, 300, 777, 1500, 64]
    shapes = [
        (gemma, gemma_lengths),
        (dict(B=4, H=8, KV=2, D=128, T=64, maxg=8), None),     # T=64
        (dict(B=1, H=2, KV=2, D=8, T=16, maxg=2), None),       # CPU tests'
        (dict(B=2, H=8, KV=2, D=16, T=32, maxg=3), None),      # GQA
        (dict(B=3, H=4, KV=1, D=32, T=16, maxg=4), None),      # MQA
        (dict(B=2, H=24, KV=2, D=64, T=16, maxg=3), None),     # 12 heads/KV
    ]
    errs = {}
    for i, (shape, lengths) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            case = paged_case(**shape, dtype=dtype, lengths=lengths, seed=i)
            err = compare(case)
            errs[(i, dtype)] = err
            print(f"  paged_flash_decode {shape} {str(dtype)[6:]}: "
                  f"max abs err {err:.3e} (tol {TOL[dtype]})")

    # timing at the Gemma-7B shape, bf16
    case = paged_case(**gemma, dtype=torch.bfloat16, lengths=gemma_lengths)
    q, kp, vp, pt, ln = case
    ms = time_ms(lambda: ops.paged_flash_decode(*case), runs=50)
    sweep = {}  # explicit block sizes, beside the launcher's own choice
    for nw in pa.NUM_WARPS:
        try:
            sweep[nw] = time_ms(lambda: ops.paged_flash_decode(
                *case, num_warps=nw), runs=20)
        except RuntimeError:  # more threads than its registers allow
            sweep[nw] = None
    plain_ms = time_ms(lambda: pa.paged_attention_ref(*case), runs=20)
    B, H, D = q.shape
    T, KV = kp.shape[1], kp.shape[2]
    S = pt.shape[1] * T
    k_dense = kp[pt.long()].reshape(B, S, KV, D).transpose(1, 2).contiguous()
    v_dense = vp[pt.long()].reshape(B, S, KV, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k_dense, v_dense, attn_mask=mask), runs=20)
    # least work: read q, the valid tokens' K and V rows, their page-table
    # entries and the lengths once; write the output once
    tokens = int(ln.sum())
    esize = q.element_size()
    groups = sum(-(-int(n) // T) for n in ln.tolist())
    bytes_moved = (q.numel() * esize + 2 * tokens * KV * D * esize
                   + groups * 4 + B * 4 + q.numel() * esize)
    flops = 4 * tokens * H * D  # q.k and p.v, per query head
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  gemma shape bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bytes_moved} bytes, {flops} flops; "
          f"{bound_ms / ms * 100:.1f}% of the bound)")
    print(f"  num_warps sweep (ms): auto {ms:.4f}, " + ", ".join(
        f"{nw}: {t:.4f}" if t is not None else f"{nw}: does not launch"
        for nw, t in sweep.items()))
    return {
        "name": "paged_flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:108",
        "launches": None,  # filled from the main path's run (phase 5)
        "max_abs_err": errs[(0, torch.bfloat16)],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# phase 4: the port on the card against the port on the CPU
# ---------------------------------------------------------------------------
TINY = ModelConfig(
    name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32", vocab_pad_multiple=64,
    rope_theta=10_000.0,
)


def phase_parity():
    rng = np.random.default_rng(SEED)
    lens, max_new = [5, 13, 3, 9], [6, 4, 8, 5]
    prompts = [rng.integers(1, TINY.vocab_size, size=n).tolist()
               for n in lens]
    params = Model(TINY, device="cpu").init(SEED)
    scfg = ServeConfig(max_seq=64, batch_slots=2, kv_layout="paged",
                       prefill_chunk=4)
    outs = {}
    before = pa.paged_flash_decode_cuda.launches
    for label, dev in (("cpu", "cpu"), ("card", DEV)):
        eng = ServeEngine(Model(TINY, device=dev), params, scfg, device=dev)
        outs[label] = eng.generate(prompts, max_new)
    launched = pa.paged_flash_decode_cuda.launches - before
    check(outs["card"].tokens == outs["cpu"].tokens,
          f"tokens differ: card {outs['card'].tokens} vs cpu "
          f"{outs['cpu'].tokens}")
    check(launched == TINY.n_layers * outs["card"].steps,
          f"{launched} kernel launches for {outs['card'].steps} steps")
    print(f"  tiny f32, 4 requests: tokens equal on card and cpu, "
          f"{outs['card'].steps} steps, {launched} kernel launches")


# ---------------------------------------------------------------------------
# phase 5: Gemma-7B at full width
# ---------------------------------------------------------------------------
def logit_consistency(model, params, prompt, generated):
    """Final logits of request ``prompt + generated[:-1]`` two ways:
    prefill of the prompt then one decode step per generated token (the
    paged decode kernel), against one chunked prefill of the whole
    sequence (dense attention).  Returns their Pearson correlation."""
    T = 16
    n = len(prompt) + len(generated)
    groups = -(-n // T)
    dev = DEV
    row = torch.arange(1, groups + 1, dtype=torch.int32, device=dev)

    cache = model.init_paged_cache(groups + 1, T)
    _, cache = model.prefill_chunk_slot_paged(
        params, {"tokens": torch.tensor([prompt], device=dev)}, cache, row,
        0)
    length = len(prompt)
    table = row[None]
    for tok in generated[:-1]:
        dl, cache = model.decode_step_multi(
            params, torch.tensor([[tok]], device=dev), cache,
            torch.tensor([length], dtype=torch.int32, device=dev), table)
        length += 1
    cache = model.init_paged_cache(groups + 1, T)
    seq = list(prompt) + list(generated[:-1])
    pl, cache = model.prefill_chunk_slot_paged(
        params, {"tokens": torch.tensor([seq], device=dev)}, cache, row, 0)
    V = model.cfg.vocab_size
    a = dl[0, -1, :V].float()
    b = pl[0, -1, :V].float()
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          "full-width logits not finite")
    return float(torch.corrcoef(torch.stack([a, b]))[0, 1])


def profile_decode_step(model, params, lengths, steps=5):
    """Where one batched decode step's time goes, at the cell's shape:
    host wall time per step without the profiler, then device time per
    kernel under ``torch.profiler``; the idle share is the part of the
    unprofiled step during which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    T, maxg = 16, 2048 // 16
    B = len(lengths)
    need = [-(-(n + 1) // T) for n in lengths]
    table = torch.zeros((B, maxg), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(need):
        table[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    cache = model.init_paged_cache(nxt, T)
    table = table.to(DEV)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    feed = torch.ones((B, 1), dtype=torch.long, device=DEV)

    def step():
        logits, _ = model.decode_step_multi(params, feed, cache, lens, table)
        return logits[:, -1].float().argmax(-1).cpu()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
    kernels = {}  # device-side events only: the kernels themselves
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + dt / 1e3 / steps
    device_ms = sum(kernels.values())
    # a device total above the step's wall time is a miscount (host-side
    # events summed as device time), not a device that was never idle
    check(device_ms <= wall_ms, f"profiled device time {device_ms:.4f} ms "
                                f"exceeds the step's wall {wall_ms:.4f} ms")
    groups = {"gemm": 0.0, "paged_decode_kernel": 0.0, "other": 0.0}
    for key, ms in kernels.items():
        g = ("paged_decode_kernel" if "paged_decode_kernel" in key else
             "gemm" if any(w in key.lower() for w in ("gemm", "nvjet",
                                                      "cutlass", "xmma"))
             else "other")
        groups[g] += ms
    print(f"  decode step at lengths {lengths}: {wall_ms:.4f} ms wall "
          f"(no profiler)")
    if not kernels:
        print("  device time per kernel: not measured (the profiler saw "
              "no device events)")
        return
    print(f"  device busy {device_ms:.4f} ms/step, idle share "
          f"{1 - device_ms / wall_ms:.3f}; by group (ms/step): "
          + ", ".join(f"{g} {ms:.4f}" for g, ms in groups.items())
          + "; top kernels (ms/step):")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:.4f}  {key[:100]}")


def phase_serve():
    cfg = get_config("gemma-7b")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(cfg, device=DEV)
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in _leaves(params))
    engine = ServeEngine(model, params, ServeConfig(
        max_seq=2048, batch_slots=8, kv_layout="paged"), device=DEV)
    rng = np.random.default_rng(SEED)
    plens = rng.integers(128, 513, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in plens]
    max_new = 32

    pa.paged_flash_decode_cuda.launches = 0
    res = engine.generate(prompts, max_new)
    launches = pa.paged_flash_decode_cuda.launches

    check(len(res.tokens) == len(prompts), "missing requests")
    for toks in res.tokens:
        check(len(toks) == max_new, f"request returned {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              "token outside the vocabulary")
    check(launches == cfg.n_layers * res.steps,
          f"{launches} kernel launches for {res.steps} decode steps "
          f"(expected {cfg.n_layers} per step)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engine.last_alloc.check_balanced()
    corr = logit_consistency(model, params, prompts[0], res.tokens[0])
    check(corr >= MIN_LOGIT_CORR,
          f"decode-path vs prefill-path logit correlation {corr:.5f} < "
          f"{MIN_LOGIT_CORR}")
    print(f"  gemma-7b bf16 full width: {n_params} params "
          f"(init {init_s:.2f} s), pool {engine.pool_groups} groups x "
          f"{engine.group_tokens} tokens, prompts {plens.tolist()}")
    print(f"  serve: prefill {res.prefill_seconds:.4f} s, decode "
          f"{res.decode_seconds:.4f} s, {res.decode_tokens_per_sec:.2f} "
          f"decode tok/s, {res.steps} steps, {launches} kernel launches "
          f"({launches / max(res.steps, 1):.0f}/step), peak "
          f"{peak_gb:.2f} GB, p50 {res.p50_latency_s:.4f} s, "
          f"p95 {res.p95_latency_s:.4f} s")
    print(f"  decode-path vs prefill-path logit correlation {corr:.6f} "
          f"(min {MIN_LOGIT_CORR})")
    profile_decode_step(model, params, [int(n) + max_new // 2
                                        for n in plens])
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1/5] device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    try:
        built = build.build("paged_attention", force=True)
        log = built.log
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores")]
        print(f"[2/5] build: paged_attention.cu in {built.seconds:.2f} s, "
              f"{len(regs)} kernels, max {max(regs, default=0)} "
              f"registers/thread, {len(spills)} with spills or stack")
        for line in spills:
            print(f"    {line}")
        print("[3/5] kernels against their plain versions")
        kernel = phase_kernels()
        print("[4/5] port on the card against the port on the cpu")
        phase_parity()
        print("[5/5] gemma-7b at full width")
        kernel["launches"] = phase_serve()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
