#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):

1. device   - the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build    - every kernel source under src/repro_torch/kernels/csrc, built
              anew (one nvcc each, all at once) even where a library of it
              is already built; each build's seconds; the registers and
              spill bytes ptxas reports for each bf16 flash-attention
              instantiation, which must not spill.
3. kernels  - each kernel against its plain PyTorch version on the card, at
              the Gemma-7B (GLA: Zamba2-1.2B) shapes and the CPU tests'
              shapes, in bf16 and f32; the bf16 tensor-core flash kernel
              at every head dim and key tile it is built for; every config
              of each tuning space (KernelSpace) that fits the card
              launched once in each dtype at a model-width shape and held
              to the plain version, and its shared memory as the library
              reports it held to the space's smem_footprint; each kernel
              timed at its main-path shape beside its bound, the plain
              version and one PyTorch library call where there is one, by
              two clocks: host-paced (``time_ms``) and device-only
              (``device_ms``: a CUDA graph of many calls on L2-cold
              inputs).  Paged decode also at every split_tokens of a sweep
              at its record shape, and through a CUDA graph replayed with
              its lengths changed in place between replays; timed at the
              record's lengths (1 to 2048) and at phase 5's
              mid-generation lengths.  Both decode kernels also at the
              shapes phase 10 gives them: paged decode over a 128-token
              window (8 groups a slot) at lengths 32 to 40, dense decode
              at B=8 over 128 entries under every block_kv of its space;
              paged decode at the shape phase 11 gives it (64 groups a
              slot, lengths of its trace, 321 to 584).
4. parity   - a tiny f32 model served on the card and on the CPU from the
              same weights, under each serve knob (fifo, sjf, interleave,
              on_demand on a pool that preempts, share_prefix with a
              copy-on-write split, draft_len=3, temperature=0.8): tokens
              and the counts of steps, prefill chunks, preemptions, CoW
              splits, shared, drafted and accepted tokens must be equal;
              the paged kernel runs n_layers times a single-token step
              and never on a verify step.  Then the drifting trace of
              tests/test_workload_retune.py under retune (RETUNE_KW,
              anchored on a phase-A-only run): tokens, counts and each
              retune event's step, signature, config, applied knobs and
              warm source equal on card and CPU.
5. serve    - Gemma-7B at full width in bf16 (random weights from a seed,
              made on the card) serves 8 requests through the paged
              continuous engine; every decode step must launch the paged
              decode kernel once per layer.  (Main path of port slice 1.)
6. tune     - ``python -m repro_torch.launch.tune --tune-kernels --arch
              gemma-7b --shape train_4k`` with a small kernel budget, into
              a temporary autotune cache: ACTS times the flash-attention,
              flash-decode, paged-decode and RMSNorm kernels at Gemma-7B's
              full width on the card; each must launch, and the kernel
              entry points must resolve the winners.  Default and winner
              re-timed beside the bound and the library call.  (Main path
              of port slice 2.)
7. autotune - Gemma-7B served again, with ServeConfig.autotune_kernels, on
              that cache: the engine tunes its decode shapes on the card,
              adopts the paged winner's group size, and decodes through
              the tuned launch config.
9. knobs    - (runs after phase 7, before phase 8, on phase 5's model)
              Gemma-7B at full width in bf16 on phase 5's engine config
              with one knob changed at a time: sjf; interleave at
              prefill_chunk 128; on_demand on a pool that holds every
              prompt but not every prompt + max_new (must preempt);
              share_prefix on prompts with a 264-token common prefix
              (must share, split a group copy-on-write and prefill fewer
              chunks than unshared); draft_len=4; temperature=0.8 under
              fifo and sjf (must sample the same tokens).  Each run must
              leave the pool balanced and launch the paged kernel n_layers
              times a single-token step (0 under drafts: every step is a
              verify step, plain attention as in the reference).  Greedy
              tokens are counted against the fifo/reserve baseline; a
              divergence must sit at a top-2 logit gap within
              DIVERGE_GAP_FACTOR times phase 5's logit error.  (Main path
              of port slice 7.)
8. zamba2   - Zamba2-1.2B at full width in bf16 (random weights from a
              seed), B=1, S=4096, under no-grad: ``Model.loss`` with
              gla_impl="pallas" and attn_impl="pallas" must launch the GLA
              kernel once per Mamba2 layer (36) and the flash-attention
              kernel once per shared-block invocation (2); its loss and
              hidden state are held to the same forward on the plain
              versions (gla_impl="jnp", attn_impl="blocked").  (Main path
              of port slice 3.)

10. cotune  - (runs last, after phase 8) ACTS co-tunes the serve engine,
              the train step and the dense decode kernel as one system:
              (a) ``launch.tune --joint`` on the analytic surrogate at
              Gemma-7B's shape (budget 24): its winners read back under
              ``model-sm90`` and it launches nothing on the card; (b) the
              live composite (``make_live_cotune_sut``) at Gemma-7B's full
              width (bf16, random weights) with the depth cut to
              COTUNE_LAYERS of 28, tuned by ``subspace_rr`` at a budget of
              COTUNE_BUDGET and persisted by ``persist_joint_winners``:
              every test ran, every serve trial launched the paged kernel
              n_layers times a single-token step (0 under drafts), the
              kernel member launched the dense decode kernel and its
              output at each block_kv tried, on its own inputs, is held to
              the plain version within TOL, every train loss is finite,
              the three winners read back under the card's key and the
              winning serve config deploys and generates every token; each
              trial's member values, the peak, and default against winner
              re-timed in turns are printed as records; (c) ``launch.tune
              --joint --real`` at the reduced config must write its three
              entries.  Each read-back is at the keys that
              ``persist_joint_winners`` derives from the composite (the
              launcher's report names them under ``persisted``).  (Main
              path of port slice 8.)
11. retune  - (runs after phase 9, before phase 8, on phase 5's model)
              Gemma-7B at full width in bf16, ServeConfig(max_seq=1024,
              batch_slots=8, prefill_chunk=128, slot_cap=3) with the
              online retuner, on phase 4's drifting trace with prompts
              x16 and generations x4 (3 distinct 320-token prompts, 48
              new tokens each, then 12 of a shared 512-token prefix + 48
              own tokens, 24 new each), anchored on a run of 6 phase-A
              requests with its acceptance left unset (the trigger then
              reads only the trace's shape, which bf16 rounding cannot
              move): at least one swap must fire past the threshold
              with knobs applied and a finite measured acceptance, the
              pool must end balanced, the paged kernel must run n_layers
              times a single-token step (none on the verify steps a swap
              to drafts brings), and the winner must read back from the
              run's cache under ``cuda-sm90`` at the event's signature;
              the first layer's paged call of a single-token step holding
              phase-B requests, captured during the run, is launched again
              on its inputs (bit for bit equal) and held to the plain
              version within TOL after the counts are read.
              Tokens are counted against the trace served without retune,
              under phase 9's divergence rule.  Records: each retune's
              host seconds, decode tok/s before and after the swap.
              (Main path of port slice 9.)
12. train   - (runs last) ``train()`` at Gemma-7B's width with the depth
              cut to TRAIN_LAYERS = 2 of 28 (1.34 B params; 28 layers'
              params, moments and gradients do not fit the card), 8 x 128
              tokens a step, 6 steps, async checkpoints every 2 steps
              (keep 1), killed at step 3 by SimulatedFailure and resumed
              from step 2, against an uninterrupted run that writes no
              checkpoint: every restored leaf's CRC32 must equal the CRC32
              taken when it was saved (before the next step ran), the
              resumed losses and final params must meet the train step's
              parity bars, and only the last checkpoint may remain (no
              ``.tmp``).  Records: bytes a checkpoint, seconds a save and
              a restore.  Then TorchMeasuredSUT on the same 2-layer
              model at 8 x 128 tokens a step under the tuner (budget 4):
              every trial's tokens/s and loss finite.

13. dense   - (runs after phase 11, before phase 8, on phase 5's model)
              Gemma-7B at full width in bf16: (a) phase 5's requests and
              engine config on the dense layout: no paged launch, phase
              5's steps and chunk counts, tokens against phase 5's under
              phase 9's divergence rule; records the dense cache's bytes,
              peak memory, decode tok/s and a profiled dense decode step
              (device busy, idle share, ms in the dense attention).  (b)
              the wave runtime, 8 prompts of 512 tokens, max_new 32,
              attn_impl="pallas": the flash kernel launches n_layers times
              a wave (whole-prompt prefill) and never in decode; its first
              call, captured during the run, is launched again on its
              inputs (bit for bit equal) and held to the plain version
              within TOL and FLASH_REL_TOL; tokens against the same wave
              under attn_impl="auto" by the divergence rule.  (c) that
              wave at prefill_chunk 128: 4 chunks and no flash launch,
              tokens against (b).  (d) that wave with autotune_kernels on
              phase 6's cache: flash at (B=8, S=SK=512) and both RMSNorm
              shapes read back under ``cuda-sm90``, and every flash call
              of the wave runs the winner's tiles.  (Main path of port
              slice 10.)
14. zamba2  - (runs after phase 8, on its model) Zamba2-1.2B at full
    serve     width in bf16 with attn_impl="pallas",
              ServeConfig(max_seq=1024, batch_slots=4, kv_layout="paged"):
              no continuous support, so the reference's wave fallback
              serves 8 prompts of 512 tokens (max_new 32) in 2 waves over
              dense caches whose pages cover batch_slots x max_seq; the
              flash kernel launches once a shared-block invocation (2 a
              wave) at H=32, D=64, one whole-prompt prefill a wave, no
              GLA launch (the reference's prefill scans with the plain
              chunked GLA); the captured flash call is held to the plain
              version; tokens against attn_impl="blocked" by the
              divergence rule (its bar from Zamba2's own decode-path vs
              prefill-path logits); f32 at one superblock's depth, card
              against CPU, by the same rule.  Records: prefill s, decode
              tok/s, peak, a profiled decode step.

Launch counts are set to 0 just before each main path (phases 5, 6, 7, 8,
each run of 9, phase 10's live run, phase 11's retune run, phase 12's
train runs and each run of 13 and 14) and read just after.  The autotune
cache of the whole run is a temporary file (REPRO_AUTOTUNE_CACHE); nothing
is written to the user's cache.  The line before the last is the card
line; the line before it the ``{"kernels": [...]}`` line; the last line
``{"ok": true, ...}``.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import autotune  # noqa: E402
from repro_torch.analysis.feasibility import kernel_feasibility  # noqa: E402
from repro_torch.configs import SHAPES, ModelConfig, get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as fd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gla as gl  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref  # noqa: E402
from repro_torch.models import Model, count_params  # noqa: E402
from repro_torch.models.gla import chunked_gla  # noqa: E402
from repro_torch.optim import tree_map  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

SEED = 0
DEV = "cuda"
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # dense TF32 on the tensor cores
# the CPU tests' tolerances (the reference kernel tests' TOL)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# flash attention at the main-path shapes (S = 4096), beside TOL: an
# output averages about 2k keys, so a typical |out| is near 0.03 and
# TOL's 2e-2 absolute part hides a fault in late key tiles.  The bar is
# on ||got - ref|| / ||ref||, over the whole output and over its last 64
# query rows (those that read the most key tiles).  bf16: rounding the
# output and P to bf16 gives a few 1e-3; the bar leaves a margin above
# that, and a wrong tile, ring stage or rescale gives 1e-1 or more.
# f32: both paths sum in f32 (about 1e-6)
FLASH_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# paged decode, beside TOL, on the rows of PAGED_LONG tokens or more: such
# a row's outputs average hundreds of values (|out| about 0.03 to 0.1 at
# 300 to 2048 tokens), so TOL hides a fault in one of its later splits or
# ring stages.  The bar is FLASH_REL_TOL's, on ||got - ref|| / ||ref|| over
# those rows, for the same reasons (bf16: output rounding, a few 1e-3)
PAGED_LONG = 300
# phase 8, bf16 at full width, kernels against plain versions: the two
# paths differ in f32 summation order (GLA, attention) and so in a few
# bf16 roundings of each layer's output, compounding over 38 layers (a
# bf16 rehearsal on the CPU at width 64 gives 1e-2 relative); a wrong
# head, step or chunk boundary gives O(1)
ZAMBA_LOSS_TOL = 1e-2       # absolute, on a loss near log(32000) = 10.4
ZAMBA_HIDDEN_REL_TOL = 5e-2  # ||h - h_plain|| / ||h_plain||
ZAMBA_ACC_FLIPS = 4          # argmax flips at near-ties, of 4096 tokens
# the same comparison in f32 at one superblock's depth: no bf16 rounding,
# the same cuBLAS GEMMs on both paths, only the GLA and attention sums
# reassociated (each ~1e-6 relative)
ZAMBA_F32_REL_TOL = 1e-3
# full-width self-consistency: decode-path and prefill-path logits differ
# only by bf16 rounding in different kernel orderings; a wrong page, head
# or length in the decode kernel decorrelates them far below this
MIN_LOGIT_CORR = 0.99
# phase 9: a knob's greedy token may differ from the fifo/reserve
# baseline's only where rounding can flip the argmax.  Re-prefill after a
# preemption, another prefill chunk and the verify attention compute the
# same logits in other orders; for the argmax to flip where the
# baseline's top-2 gap is g, the two runs' logits must differ by g/2 or
# more at some token.  Phase 5 measures that difference between the
# decode path and the prefill path (logit_consistency's max abs); the
# bar is twice the flip condition, 4x it, for positions and requests
# other than the one it was measured on.  A wrong page, length or mask
# gives gaps far above it.
DIVERGE_GAP_FACTOR = 4.0
# the tune phase's budget per kernel (tests, each a warm-up and 3 timed
# launches); the serve engine tunes its own shapes at its default budget
TUNE_BUDGET = 8
# the H100's L2: the device-only clock rotates among input sets that
# together hold at least twice this, so each call reads device memory
L2_BYTES = 50 * 2**20
# kernel record name -> its wrapper, whose launch count the paths read
WRAPPERS = {
    "paged_flash_decode": pa.paged_flash_decode_cuda,
    "flash_attention": fa.flash_attention_cuda,
    "flash_decode": fd.flash_decode_cuda,
    "rmsnorm": rn.rmsnorm_cuda,
    "gla": gl.gla_cuda,
}
SOURCES = {
    "paged_flash_decode": ("paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:108"),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "flash_decode": ("decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:71"),
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:28"),
    "gla": ("gla.cu", "src/repro/kernels/gla.py:81"),
}


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


def reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def time_ms(fn, runs: int, warmup: int = 3) -> float:
    """Device ms a call: CUDA events around ``runs`` calls issued back to
    back, after warm-up, over ``runs``.  The host issues the next launch
    while the card runs the last, so a kernel longer than its wrapper's
    host work is timed alone; a shorter one shows the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / runs


def cold_sets(make_inputs) -> list:
    """Input sets from ``make_inputs()``, enough (2 to 8) that together
    they hold at least twice the L2: a call that rotates among them finds
    its inputs in device memory, as the bound assumes."""
    sets = [make_inputs()]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in sets[0] if isinstance(t, torch.Tensor)}
    per_set = sum(storages.values())
    while len(sets) < min(8, max(2, -(-2 * L2_BYTES // per_set))):
        sets.append(make_inputs())
    return sets


def device_ms(fn, sets, calls: int = 32, replays: int = 5) -> float:
    """Device-only ms a call: ``fn(*inputs)`` captured ``calls`` times in
    one CUDA graph, rotating among ``sets`` (``cold_sets``), then CUDA
    events around ``replays`` replays.  The replays run none of the
    wrapper's host work (resolution, checks, ctypes): only the launches,
    back to back on the card.  The ctypes launches go on the current
    stream, which is the capture stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for inputs in sets:
            fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(calls):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / (replays * calls)
    del graph
    return ms


def ptxas_kernels(log: str) -> list:
    """(entry function, registers, spill store bytes, spill load bytes)
    for each kernel of a build's ``-Xptxas -v`` report."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line and name:
            w = line.replace(",", "").split()
            spill = (int(w[w.index("spill") - 2]),
                     int(w[w.index("loads") - 3]))
        elif "Used" in line and "registers" in line and name:
            w = line.replace(",", "").split()
            out.append((name, int(w[w.index("registers") - 1]), *spill))
            name, spill = None, (0, 0)
    return out


# ---------------------------------------------------------------------------
# bounds and library yardsticks
# ---------------------------------------------------------------------------
def bound_of(bytes_moved: float, flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S):
    """(least ms, what binds it) at the H100 SXM's published peaks."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def flash_work(B, S, SK, H, KV, D, esize, q_offset=None):
    """Bytes (q, k, v read once, the output written once) and flops (Q.K
    and P.V over the (query, key) pairs the causal mask keeps, queries at
    the end of the keys) of causal attention."""
    off = SK - S if q_offset is None else q_offset
    pairs = sum(min(SK, off + i + 1) for i in range(S))
    return ((2 * B * S * H * D + 2 * B * SK * KV * D) * esize,
            4 * B * H * D * pairs)


def decode_work(B, H, KV, D, kv_len, esize):
    """Bytes (the first kv_len K and V rows, q and the output, kv_len) and
    flops (q.k and p.v per query head) of dense-cache decode attention."""
    return (2 * B * kv_len * KV * D * esize + 2 * B * H * D * esize + 4,
            4 * B * H * kv_len * D)


def rms_work(rows, D, esize):
    """Bytes (x read and the output written once, the f32 scale) and
    flops (square, sum, two products an element) of RMSNorm."""
    return 2 * rows * D * esize + D * 4, 4 * rows * D


def gla_work(B, S, H, dk, dv, chunk, esize, shared_qk=False):
    """Bytes (q and k read once: one (B, S, dk) row each when they are
    broadcast over the heads; v, the f32 gates, y and the f32 final state
    once) and flops of chunked GLA: q.k over the (t, s) pairs of each chunk
    with s <= t (once for all heads when q and k are broadcast: only the
    decay differs a head), the decay multiply and p.v a pair and head, and
    the inter-chunk term and the state update, 2 * dk * dv a step and head
    each."""
    qk_rows = B * S * (1 if shared_qk else H)
    L = min(chunk, S)
    pairs = sum(n * (n + 1) // 2 for n in
                [L] * (S // L) + ([S % L] if S % L else []))
    nbytes = (2 * qk_rows * dk * esize + 2 * B * S * H * dv * esize
              + B * S * H * 4 + B * H * dk * dv * 4)
    qk_heads = 1 if shared_qk else H
    flops = (B * qk_heads * pairs * 2 * dk
             + B * H * (pairs * (1 + 2 * dv) + 4 * S * dk * dv))
    return nbytes, flops


def sdpa(q4, k4, v4, **kw):
    return torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, enable_gqa=q4.shape[1] != k4.shape[1], **kw)


def rnd(g, shape, dtype):
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def close(got, want, what, scaled: bool = False) -> float:
    """Max abs error of a kernel against its plain version; fails unless
    every element is within tol + tol * |ref|, tol the CPU tests'
    tolerance.  ``scaled`` makes the absolute part tol * max |ref|: GLA's
    outputs are f32 sums of terms as large as the largest output (dk-long
    dot products, an in-block scan against ``torch.cumsum``'s scan), which
    an element-relative bar cannot hold where they cancel."""
    torch.cuda.synchronize()
    tol = TOL[want.dtype]
    w = want.float()
    err = (got.float() - w).abs()
    atol = tol * float(w.abs().max()) if scaled else tol
    check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
    check(bool((err <= atol + tol * w.abs()).all()),
          f"{what}: kernel disagrees with plain version: max abs err "
          f"{float(err.max()):.3e} > {atol:.3e} + {tol} * |ref|")
    return float(err.max())


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| in f32."""
    w = want.float()
    return float((got.float() - w).norm() / w.norm())


def paged_close(got, want, ln, what):
    """``close`` for paged decode, and over the rows of ``PAGED_LONG``
    tokens or more the norm-relative bar ``FLASH_REL_TOL``; returns the
    max abs error and that norm-relative error (None without such rows)."""
    err = close(got, want, what)
    long_rows = ln >= PAGED_LONG
    if not bool(long_rows.any()):
        return err, None
    rel = rel_err(got[long_rows], want[long_rows])
    bar = FLASH_REL_TOL[want.dtype]
    check(rel <= bar, f"{what}: norm-relative error {rel:.3e} of the rows "
                      f"of {PAGED_LONG} tokens or more above {bar}")
    return err, rel


def record(name, err, ms, plain_ms, bound, library_ms, dev_ms,
           library_dev_ms):
    """A kernel's line: ``ms``, ``plain_ms`` and ``library_ms`` by the
    host-paced clock, ``device_ms`` and ``library_device_ms`` by the
    device-only one."""
    src, replaces = SOURCES[name]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms,
            "device_ms": dev_ms, "library_device_ms": library_dev_ms}


def clocks(what, ms, dev_ms, bound, lib_ms=None, lib_dev_ms=None,
           lib="library"):
    """One line of both clocks for a kernel (and its library call)."""
    line = (f"  {what}: kernel {ms:.4f} ms host-paced, {dev_ms:.4f} ms "
            f"device-only ({bound[0] / dev_ms * 100:.1f}% of the "
            f"{bound[0]:.4f} ms bound by {bound[1]})")
    if lib_ms is not None:
        line += (f"; {lib} {lib_ms:.4f} ms host-paced, {lib_dev_ms:.4f} ms "
                 f"device-only")
    print(line)


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
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


# the Gemma-7B decode shape of the main path: B=8 slots, 16 heads of 256,
# 16-token groups, 128 groups (max_seq 2048) per slot; the record's ragged
# lengths, and phase 5's mid-generation lengths (its prompts, drawn from
# SEED as phase_serve draws them, plus half of max_new: the lengths of
# profile_decode_step)
PAGED_GEMMA = dict(B=8, H=16, KV=16, D=256, T=16, maxg=128)
PAGED_RECORD_LENGTHS = [1, 16, 17, 2048, 300, 777, 1500, 64]
# phase 10's live serve member: a 128-token window (8 groups a slot),
# 1 to 8 slots, 32-token prompts plus 8 generated (lengths 32 to 40), at
# which the launcher picks a split that no shape above uses
PAGED_COTUNE = dict(H=16, KV=16, D=256, T=16, maxg=8)
PAGED_ENGINE_LENGTHS = [int(n) + 16 for n in np.random.default_rng(
    SEED).integers(128, 513, size=8)]


def paged_work(q, kp, ln):
    """Bytes (q, the valid tokens' K and V rows, their page-table entries
    and the lengths read once, the output written once) and flops (q.k and
    p.v a query head) of paged decode at these lengths."""
    B, H, D = q.shape
    T, KV = kp.shape[1], kp.shape[2]
    lengths = [int(n) for n in ln.tolist()]
    tokens, esize = sum(lengths), q.element_size()
    groups = sum(-(-n // T) for n in lengths)
    return (2 * q.numel() * esize + 2 * tokens * KV * D * esize
            + groups * 4 + B * 4, 4 * tokens * H * D)


def paged_timing(what, lengths):
    """Both clocks for the kernel at the launcher's split, its plain
    version and SDPA on the K/V gathered through the page table (masked
    past each length), bf16 at the Gemma-7B decode shape; returns them
    with the bound and the cold input sets."""
    def make():
        return paged_case(**PAGED_GEMMA, dtype=torch.bfloat16,
                          lengths=lengths)

    sets = cold_sets(make)
    case = sets[0]
    q, kp, vp, pt, ln = case
    ms = time_ms(lambda: ops.paged_flash_decode(*case), runs=50)
    plain_ms = time_ms(lambda: pa.paged_attention_ref(*case), runs=20)
    B, H, D = q.shape
    T, KV = kp.shape[1], kp.shape[2]
    S = pt.shape[1] * T
    mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None].long())
    mask = mask[:, None, None, :]

    def gathered(q_, kp_, vp_, pt_, _):
        return (q_[:, :, None], *(
            p[pt_.long()].reshape(B, S, KV, D).transpose(1, 2).contiguous()
            for p in (kp_, vp_)))

    lib_sets = [gathered(*s) for s in sets]
    library_ms = time_ms(lambda: sdpa(*lib_sets[0], attn_mask=mask),
                         runs=20)
    dev_ms = device_ms(ops.paged_flash_decode, sets)
    lib_dev_ms = device_ms(lambda *a: sdpa(*a, attn_mask=mask), lib_sets)
    del lib_sets
    work = paged_work(q, kp, ln)
    bound = bound_of(*work)
    split = pa.auto_split_tokens(H, KV, T, S, D, q.element_size(),
                                 torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
    print(f"  gemma {what} bf16 (B={B} T={T} lengths {lengths}, the "
          f"launcher's split of {split} tokens): plain {plain_ms:.4f} ms "
          f"({work[0]} bytes, {work[1]} flops)")
    clocks(f"gemma {what}", ms, dev_ms, bound, library_ms, lib_dev_ms,
           "sdpa")
    return ms, plain_ms, bound, library_ms, dev_ms, lib_dev_ms, sets


def paged_graph_replay():
    """A CUDA graph of one call at the Gemma-7B decode shape, replayed with
    the lengths changed in place between replays: each replay must equal
    a fresh call bit for bit (the merge counters are back at 0) and the
    plain version within TOL."""
    case = paged_case(**PAGED_GEMMA, dtype=torch.bfloat16,
                      lengths=PAGED_RECORD_LENGTHS, seed=7)
    ln = case[4]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # built and opted in before the capture
        ops.paged_flash_decode(*case)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = ops.paged_flash_decode(*case)
    worst = worst_rel = 0.0
    for lengths in (PAGED_RECORD_LENGTHS, PAGED_ENGINE_LENGTHS,
                    PAGED_RECORD_LENGTHS[::-1], PAGED_RECORD_LENGTHS):
        ln.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        fresh = ops.paged_flash_decode(*case)
        torch.cuda.synchronize()
        check(torch.equal(out, fresh), f"paged decode graph replay at "
                                       f"lengths {lengths} differs from a "
                                       f"fresh call")
        err, rel = paged_close(out, pa.paged_attention_ref(*case), ln,
                               f"paged decode graph replay {lengths}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    del graph
    print(f"  paged decode CUDA graph replayed at 4 length sets (changed "
          f"in place): equal to a fresh call bit for bit, max abs err "
          f"{worst:.3e} (tol {TOL[torch.bfloat16]}); rows of {PAGED_LONG} "
          f"tokens or more: norm-relative err {worst_rel:.3e} (bar "
          f"{FLASH_REL_TOL[torch.bfloat16]})")


def kernels_paged():
    shapes = [
        (PAGED_GEMMA, PAGED_RECORD_LENGTHS),
        (dict(B=4, H=8, KV=2, D=128, T=64, maxg=8), None),     # T=64
        (dict(B=1, H=2, KV=2, D=8, T=16, maxg=2), None),       # CPU tests'
        (dict(B=2, H=8, KV=2, D=16, T=32, maxg=3), None),      # GQA
        (dict(B=3, H=4, KV=1, D=32, T=16, maxg=4), None),      # MQA
        (dict(B=2, H=24, KV=2, D=64, T=16, maxg=3), None),     # 12 heads/KV
        (dict(PAGED_COTUNE, B=8), list(range(33, 41))),        # phase 10's
        (dict(PAGED_COTUNE, B=3), [32, 36, 40]),
        (dict(PAGED_COTUNE, B=1), [40]),
        # phase 11's: the Gemma-7B decode shape at max_seq 1024 (64
        # groups a slot), lengths of the drifting trace at its scale
        (dict(PAGED_GEMMA, maxg=RETUNE_BASE["max_seq"] // PAGED_GEMMA["T"]),
         PAGED_RETUNE_LENGTHS),
    ]
    errs = {}
    for i, (shape, lengths) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            case = paged_case(**shape, dtype=dtype, lengths=lengths, seed=i)
            err, rel = paged_close(ops.paged_flash_decode(*case),
                                   pa.paged_attention_ref(*case), case[4],
                                   f"paged_flash_decode {shape}")
            errs[(i, dtype)] = err
            line = (f"  paged_flash_decode {shape} {str(dtype)[6:]}: "
                    f"max abs err {err:.3e} (tol {TOL[dtype]})")
            if rel is not None:
                line += (f"; rows of {PAGED_LONG} tokens or more: "
                         f"norm-relative err {rel:.3e} (bar "
                         f"{FLASH_REL_TOL[dtype]})")
            print(line)
    paged_graph_replay()

    timed = paged_timing("record shape", PAGED_RECORD_LENGTHS)
    ms, plain_ms, bound, library_ms, dev_ms, lib_dev_ms, sets = timed
    # every split of the sweep against the plain version, device-only
    want = pa.paged_attention_ref(*sets[0])
    sweep = {}
    for st in (16, 32, 64, 128, 256, 512, 1024, 2048):
        def call(*a):
            return pa.paged_flash_decode_cuda(*a, split_tokens=st)

        err, rel = paged_close(call(*sets[0]), want, sets[0][4],
                               f"paged split_tokens {st}")
        sweep[st] = (device_ms(call, sets), err, rel)
    del sets, want
    print(f"  split_tokens sweep at the record shape, device-only ms (max "
          f"abs err, norm-relative err of the rows of {PAGED_LONG} tokens or "
          f"more): " + ", ".join(f"{st}: {t:.4f} ({e:.2e}, {r:.2e})"
                                 for st, (t, e, r) in sweep.items()))
    paged_timing("engine shape", PAGED_ENGINE_LENGTHS)
    return record("paged_flash_decode", errs[(0, torch.bfloat16)], ms,
                  plain_ms, bound, library_ms, dev_ms, lib_dev_ms)


def flash_tc_sweep(g):
    """The bf16 tensor-core kernel at every head dim and key tile (wgmma
    N) it is built for, with ragged Sq and Sk, a window and a q_offset;
    D=256 at 128 keys needs 256 KB of shared memory and must be refused."""
    worst = 0.0
    for D in fa.HEAD_DIMS:
        for bk in fa.TILE_KEYS:
            cases = [  # B, S, SK, H, KV, causal, window, q_offset, bq
                (2, 100, 130, 4, 2, True, 0, 30, 128),
                (1, 70, 90, 4, 1, True, 24, 20, 32),
                (1, 48, 40, 2, 2, False, 0, 0, 64),
            ]
            for B, S, SK, H, KV, causal, window, off, bq in cases:
                q, k, v = (rnd(g, (B, S, H, D), torch.bfloat16),
                           rnd(g, (B, SK, KV, D), torch.bfloat16),
                           rnd(g, (B, SK, KV, D), torch.bfloat16))
                call = (lambda: ops.flash_attention(
                    q, k, v, causal=causal, window=window, q_offset=off,
                    block_q=bq, block_kv=bk))
                if fa.smem_bytes(D, "bfloat16", min(bq, S),
                                 min(bk, SK)) > autotune.smem_limit(DEV):
                    try:
                        call()
                        check(False, f"flash D={D} block_kv={bk} launched")
                    except ValueError as e:
                        check("shared memory" in str(e), str(e))
                    continue
                worst = max(worst, close(call(), attention_ref(
                    q, k, v, causal=causal, window=window, q_offset=off),
                    f"flash tc D={D} block_kv={bk} S={S} SK={SK}"))
    print(f"  flash bf16 tensor-core kernel: every D in {fa.HEAD_DIMS} x "
          f"key tile in {fa.TILE_KEYS} (D=256 x 128 refused: shared "
          f"memory), ragged Sq and Sk, a window, a q_offset: max abs err "
          f"{worst:.3e} (tol {TOL[torch.bfloat16]})")


def flash_timing(g, what, shape):
    """Both clocks for the kernel at its default tiles, the plain version
    and SDPA at a causal main-path shape, bf16."""
    B, S, SK, H, KV, D = shape[:6]
    dtype = torch.bfloat16

    def make():
        return (rnd(g, (B, S, H, D), dtype), rnd(g, (B, SK, KV, D), dtype),
                rnd(g, (B, SK, KV, D), dtype))

    sets = cold_sets(make)
    q, k, v = sets[0]
    ms = time_ms(lambda: ops.flash_attention(q, k, v), runs=10)
    dev_ms = device_ms(ops.flash_attention, sets)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), runs=5)
    sets = [tuple(t.transpose(1, 2).contiguous() for t in inputs)
            for inputs in sets]  # SDPA's (B, H, S, D), the same values
    q4, k4, v4 = sets[0]
    lib_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), runs=10)
    lib_dev_ms = device_ms(lambda *a: sdpa(*a, is_causal=True), sets)
    del sets, q4, k4, v4
    work = flash_work(B, S, SK, H, KV, D, q.element_size())
    bound = bound_of(*work)
    print(f"  {what} bf16 (B={B} S={S} H={H} D={D}, causal, default tiles "
          f"{ops.DEFAULT_BLOCKS['flash_attention']}): plain {plain_ms:.4f} "
          f"ms ({work[0]} bytes, {work[1]} flops)")
    clocks(what, ms, dev_ms, bound, lib_ms, lib_dev_ms, "sdpa")
    return ms, plain_ms, bound, lib_ms, dev_ms, lib_dev_ms


def kernels_flash():
    g = torch.Generator(device=DEV).manual_seed(1)
    gemma = (1, 4096, 4096, 16, 16, 256, True, 0, 0, None, None)
    shapes = [  # B, S, SK, H, KV, D, causal, window, q_offset, bq, bk
        (1, 16, 16, 1, 1, 8, True, 0, 0, 16, 16),      # the CPU tests'
        (2, 64, 64, 4, 2, 16, True, 0, 0, 32, 32),     # GQA
        (1, 96, 96, 8, 1, 32, True, 0, 0, 32, 32),     # MQA
        (2, 100, 100, 4, 4, 16, True, 0, 0, 32, 16),   # ragged tiles
        (1, 128, 128, 2, 2, 64, True, 0, 0, 64, 128),  # bq < bk
        (2, 72, 72, 4, 2, 16, True, 24, 0, 16, 16),    # sliding window
        (1, 48, 48, 2, 2, 16, False, 0, 0, 16, 16),    # non-causal
        (2, 40, 70, 4, 2, 16, True, 16, 30, 16, 16),   # q_offset + window
        (1, 300, 500, 16, 16, 256, True, 0, 200, None, None),  # Gemma width
        gemma,                                         # train_4k, defaults
        ZAMBA_FLASH,                                   # Zamba2 shared block
        GEMMA_WAVE_FLASH,                              # phase 13's wave
        ZAMBA_WAVE_FLASH,                              # phase 14's wave
    ]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            B, S, SK, H, KV, D, causal, window, off, bq, bk = shape
            q, k, v = (rnd(g, (B, S, H, D), dtype),
                       rnd(g, (B, SK, KV, D), dtype),
                       rnd(g, (B, SK, KV, D), dtype))
            got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=off, block_q=bq, block_kv=bk)
            want = attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=off)
            errs[(shape, dtype)] = err = close(got, want,
                                               f"flash_attention {shape}")
            line = (f"  flash_attention {shape[:9]} {str(dtype)[6:]}: max "
                    f"abs err {err:.3e} (tol {TOL[dtype]})")
            if shape in (gemma, ZAMBA_FLASH, GEMMA_WAVE_FLASH,
                         ZAMBA_WAVE_FLASH):
                rel = (rel_err(got, want),
                       rel_err(got[:, -64:], want[:, -64:]))
                check(max(rel) <= FLASH_REL_TOL[dtype],
                      f"flash_attention {shape} {dtype}: norm-relative "
                      f"error {rel} above {FLASH_REL_TOL[dtype]}")
                line += (f"; norm-relative err {rel[0]:.3e}, last 64 rows "
                         f"{rel[1]:.3e} (bar {FLASH_REL_TOL[dtype]})")
            print(line)
            del q, k, v, got, want
    flash_tc_sweep(g)
    timed = flash_timing(g, "gemma train_4k", gemma)
    flash_timing(g, "zamba2 shared block", ZAMBA_FLASH)
    print(f"  zamba2 shared block bf16: max abs err "
          f"{errs[(ZAMBA_FLASH, torch.bfloat16)]:.3e}")
    # serve prefill: the wave shapes phases 13 and 14 give the kernel
    waves = {}
    for what, shape in (("gemma wave prefill", GEMMA_WAVE_FLASH),
                        ("zamba2 wave prefill", ZAMBA_WAVE_FLASH)):
        w_ms, w_plain, w_bound, w_lib, w_dev, w_lib_dev = flash_timing(
            g, what, shape)
        waves[what.replace(" ", "_")] = {
            "shape": list(shape[:6]),
            "max_abs_err": errs[(shape, torch.bfloat16)], "ms": w_ms,
            "device_ms": w_dev, "plain_ms": w_plain, "bound_ms": w_bound[0],
            "bound_by": w_bound[1], "library_ms": w_lib,
            "library_device_ms": w_lib_dev}
    ms, plain_ms, bound, lib_ms, dev_ms, lib_dev_ms = timed
    rec = record("flash_attention", errs[(gemma, torch.bfloat16)], ms,
                 plain_ms, bound, lib_ms, dev_ms, lib_dev_ms)
    rec["serve_prefill"] = waves
    return rec


# B, S, SK, H, KV, D, causal, window, q_offset, block_q, block_kv
ZAMBA_FLASH = (1, 4096, 4096, 32, 32, 64, True, 0, 0, None, None)
# whole-prompt wave prefill at 512-token prompts: Gemma-7B on 8 slots
# (phase 13), Zamba2-1.2B's shared block on 4 (phase 14)
GEMMA_WAVE_FLASH = (8, 512, 512, 16, 16, 256, True, 0, 0, None, None)
ZAMBA_WAVE_FLASH = (4, 512, 512, 32, 32, 64, True, 0, 0, None, None)


# phase 10's live kernel member: B=8 slots over a 128-token window at
# Gemma-7B's heads (B, S, H, KV, D, block_kv)
COTUNE_DECODE = (8, 128, 16, 16, 256, None)


def cotune_block_kv(g):
    """Dense decode at phase 10's kernel-member shape under every block_kv
    of its tuning space (0: the launcher's split), bf16 over the whole
    window as the member times it, against the plain version within
    TOL."""
    B, S, H, KV, D, _ = COTUNE_DECODE
    dtype = torch.bfloat16
    q, k, v = (rnd(g, (B, H, D), dtype), rnd(g, (B, S, KV, D), dtype),
               rnd(g, (B, S, KV, D), dtype))
    kl = torch.tensor(S, dtype=torch.int32, device=DEV)
    want = fd.decode_attention_ref(q, k, v, kl)
    errs = {}
    space = autotune.KernelSpace("decode_attention").space()
    for bkv in space["block_kv"].choices:
        errs[bkv] = close(fd.flash_decode_cuda(q, k, v, kl, block_kv=bkv),
                          want,
                          f"flash_decode {COTUNE_DECODE[:5]} block_kv {bkv}")
    print(f"  flash_decode {COTUNE_DECODE[:5]} bf16 (phase 10's kernel "
          f"member) at every block_kv of its space, max abs err: "
          + ", ".join(f"{b}: {e:.3e}" for b, e in errs.items())
          + f" (tol {TOL[dtype]})")


def kernels_decode():
    g = torch.Generator(device=DEV).manual_seed(2)
    gemma = (8, 2048, 16, 16, 256, None)  # the engine's slots and cache
    shapes = [  # B, S, H, KV, D, block_kv
        (1, 32, 2, 2, 8, 16),       # the CPU tests'
        (2, 96, 8, 2, 16, 32),
        (1, 100, 4, 1, 32, 32),     # MQA + ragged cache
        (2, 80, 24, 2, 64, 32),     # 12 query heads per KV head
        (1, 4096, 16, 16, 256, None),  # train_4k's tune shape
        COTUNE_DECODE,
        gemma,
    ]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            B, S, H, KV, D, bkv = shape
            q, k, v = (rnd(g, (B, H, D), dtype),
                       rnd(g, (B, S, KV, D), dtype),
                       rnd(g, (B, S, KV, D), dtype))
            for kv_len in (1, S // 3, S):
                kl = torch.tensor(kv_len, dtype=torch.int32, device=DEV)
                got = ops.flash_decode(q, k, v, kl, block_kv=bkv)
                errs[(shape, kv_len, dtype)] = err = close(
                    got, fd.decode_attention_ref(q, k, v, kv_len),
                    f"flash_decode {shape} kv_len {kv_len}")
            zero = ops.flash_decode(q, k, v, 0, block_kv=bkv)
            torch.cuda.synchronize()
            check(bool((zero == 0).all()), f"flash_decode {shape}: kv_len 0 "
                                           "must give zeros")
            print(f"  flash_decode {shape[:5]} {str(dtype)[6:]}: max abs err "
                  f"{max(errs[(shape, n, dtype)] for n in (1, S // 3, S)):.3e}"
                  f" over kv_len 1, {S // 3}, {S} (tol {TOL[dtype]}); "
                  f"kv_len 0 gives zeros")
    cotune_block_kv(g)
    B, S, H, KV, D = gemma[:5]
    dtype = torch.bfloat16
    q, k, v = (rnd(g, (B, H, D), dtype), rnd(g, (B, S, KV, D), dtype),
               rnd(g, (B, S, KV, D), dtype))
    kl = torch.tensor(S, dtype=torch.int32, device=DEV)
    ms = time_ms(lambda: ops.flash_decode(q, k, v, kl), runs=50)
    plain_ms = time_ms(lambda: fd.decode_attention_ref(q, k, v, kl), runs=20)
    q4 = q[:, :, None, :]
    k4, v4 = (t.transpose(1, 2).contiguous() for t in (k, v))
    library_ms = time_ms(lambda: sdpa(q4, k4, v4), runs=20)

    sets = cold_sets(lambda: (rnd(g, (B, H, D), dtype),
                              rnd(g, (B, S, KV, D), dtype),
                              rnd(g, (B, S, KV, D), dtype), kl))
    dev_ms = device_ms(ops.flash_decode, sets)
    lib_dev_ms = device_ms(sdpa, [
        (q_[:, :, None, :], *(t.transpose(1, 2).contiguous()
                              for t in (k_, v_)))
        for q_, k_, v_, _ in sets])  # the same values in SDPA's layout
    del sets
    work = decode_work(B, H, KV, D, S, q.element_size())
    bound = bound_of(*work)
    print(f"  gemma engine decode shape bf16 (B={B} S={S} full, default "
          f"block_kv): plain {plain_ms:.4f} ms ({work[0]} bytes)")
    clocks("gemma engine decode shape", ms, dev_ms, bound, library_ms,
           lib_dev_ms, "sdpa")
    return record("flash_decode", errs[(gemma, S, dtype)], ms, plain_ms,
                  bound, library_ms, dev_ms, lib_dev_ms)


def kernels_rmsnorm():
    g = torch.Generator(device=DEV).manual_seed(3)
    gemma = ((4096, 3072), None)  # train_4k rows at d_model
    shapes = [((4, 32), 4), ((3, 7, 64), 16), ((1, 128), 256),
              ((5, 100), 32), ((250, 3072), 8), gemma]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, br in shapes:
            x = rnd(g, shape, dtype)
            s = torch.randn(shape[-1], generator=g, device=DEV)
            errs[(shape, dtype)] = err = close(
                ops.rmsnorm(x, s, block_rows=br), rmsnorm_ref(x, s),
                f"rmsnorm {shape}")
            print(f"  rmsnorm {shape} {str(dtype)[6:]}: max abs err "
                  f"{err:.3e} (tol {TOL[dtype]})")
    x = rnd(g, (64, 3072), torch.bfloat16)
    s = rnd(g, (3072,), torch.bfloat16)  # a scale in x's dtype
    err = close(ops.rmsnorm(x, s), rmsnorm_ref(x, s), "rmsnorm bf16 scale")
    print(f"  rmsnorm (64, 3072) bf16 with a bf16 scale: max abs err "
          f"{err:.3e}")
    # the register path, and the loop path (d not a multiple of a 16-byte
    # vector, or a row too long for the registers), both dtypes, with a
    # bf16 scale on bf16 rows
    for shape in ((64, 2048), (64, 3002), (16, 10240)):
        for dtype in (torch.bfloat16, torch.float32):
            for s_dtype in {torch.float32, dtype}:
                x = rnd(g, shape, dtype)
                s = rnd(g, (shape[-1],), s_dtype)
                close(ops.rmsnorm(x, s), rmsnorm_ref(x, s),
                      f"rmsnorm {shape} {dtype} scale {s_dtype}")
    print("  rmsnorm register path (64, 2048), loop path (64, 3002) and "
          "(16, 10240), bf16 and f32, f32 and bf16 scales: within tol")
    rows, D = gemma[0]
    sets = cold_sets(lambda: (rnd(g, (rows, D), torch.bfloat16),
                              torch.randn(D, generator=g, device=DEV)))
    x, s = sets[0]
    ms = time_ms(lambda: ops.rmsnorm(x, s), runs=50)
    plain_ms = time_ms(lambda: rmsnorm_ref(x, s), runs=20)
    s_lib = s.to(x.dtype)

    def library(x_, w_):
        return torch.nn.functional.rms_norm(x_, (D,), weight=w_, eps=1e-6)

    library_ms = time_ms(lambda: library(x, s_lib), runs=20)
    # the kernel and F.rms_norm read the same buffers by the device clock
    dev_ms = device_ms(ops.rmsnorm, sets)
    lib_dev_ms = device_ms(library, [(x_, s_.to(x_.dtype))
                                     for x_, s_ in sets])
    del sets
    work = rms_work(rows, D, x.element_size())
    bound = bound_of(*work)
    print(f"  gemma train_4k rows bf16 (ROWS={rows} D={D}, default "
          f"block_rows): plain {plain_ms:.4f} ms ({work[0]} bytes)")
    clocks("gemma train_4k rows", ms, dev_ms, bound, library_ms, lib_dev_ms,
           "F.rms_norm")
    return record("rmsnorm", errs[(gemma[0], torch.bfloat16)], ms, plain_ms,
                  bound, library_ms, dev_ms, lib_dev_ms)


def gla_case(g, B, S, H, dk, dv, dtype, shared_qk):
    """q, k, v and log-gates -|N(0,1)| * 0.3 (the tuning space's); with
    ``shared_qk`` q and k are one (B, S, dk) row each broadcast over the
    heads, as Mamba2 passes them."""
    if shared_qk:
        rows = rnd(g, (B, S, 2 * dk), dtype)
        q = rows[:, :, None, :dk].expand(B, S, H, dk)
        k = rows[:, :, None, dk:].expand(B, S, H, dk)
    else:
        q, k = rnd(g, (B, S, H, dk), dtype), rnd(g, (B, S, H, dk), dtype)
    v = rnd(g, (B, S, H, dv), dtype)
    log_g = -(torch.randn((B, S, H), generator=g, device=DEV).abs() * 0.3)
    return q, k, v, log_g


def kernels_gla():
    g = torch.Generator(device=DEV).manual_seed(4)
    zamba = (1, 4096, 64, 64, 64, 256, True)  # phase 8's 36 launches
    shapes = [  # B, S, H, dk, dv, chunk, q and k broadcast over heads
        (1, 16, 1, 4, 4, 8, False),       # the CPU tests' (TestGLA)
        (2, 64, 3, 8, 16, 16, False),
        (1, 70, 2, 16, 8, 32, False),     # ragged
        (2, 128, 4, 32, 32, 64, False),
        (2, 1000, 4, 64, 32, 256, True),  # ragged at the model's chunk
        (1, 300, 2, 128, 128, 256, False),  # the largest head it takes
        (1, 100, 2, 96, 40, 64, False),   # dims no power of two
        zamba,
    ]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            B, S, H, dk, dv, chunk, shared = shape
            q, k, v, lg = gla_case(g, B, S, H, dk, dv, dtype, shared)
            y, st = ops.gla(q, k, v, lg, chunk=chunk)
            yr, sr = chunked_gla(q, k, v, lg, chunk=chunk)
            check(y.dtype == v.dtype and st.dtype == torch.float32,
                  f"gla {shape}: output dtypes {y.dtype}, {st.dtype}")
            errs[(shape, dtype)] = err = close(y, yr, f"gla {shape} y",
                                               scaled=True)
            s_err = close(st, sr, f"gla {shape} final state", scaled=True)
            print(f"  gla {shape} {str(dtype)[6:]}: max abs err y {err:.3e} "
                  f"(max |y| {float(yr.float().abs().max()):.3e}), state "
                  f"{s_err:.3e} (tol {TOL[dtype]} * (max |ref| + |ref|))")
            del q, k, v, lg, y, st, yr, sr
    # xLSTM's mLSTM head (dk=512, dv=513 with the ones column): its state
    # does not fit one block, and the wrapper says so
    q, k, v, lg = gla_case(g, 1, 16, 2, 512, 513, torch.float32, False)
    try:
        ops.gla(q, k, v, lg)
        check(False, "gla took dk=512, dv=513")
    except ValueError as e:
        check("dk=512" in str(e), f"gla dk=512: unclear error {e}")
        print(f"  gla dk=512, dv=513 rejected: {e}")
    # no gradient, as gla_pallas has none
    q, k, v, lg = gla_case(g, 1, 32, 2, 16, 16, torch.float32, False)
    try:
        ops.gla(q.requires_grad_(), k, v, lg)
        check(False, "gla took an input that requires grad")
    except RuntimeError as e:
        check("no gradient" in str(e), f"gla requires_grad: unclear {e}")
        print("  gla on an input that requires grad raises (no gradient)")

    B, S, H, dk, dv, chunk, shared = zamba
    dtype = torch.float32  # Mamba2's q, k, v after the f32 conv
    q, k, v, lg = gla_case(g, B, S, H, dk, dv, dtype, shared)
    ms = time_ms(lambda: ops.gla(q, k, v, lg, chunk=chunk), runs=10)
    plain_ms = time_ms(lambda: chunked_gla(q, k, v, lg, chunk=chunk), runs=3,
                       warmup=1)
    dev_ms = device_ms(lambda *a: ops.gla(*a, chunk=chunk), cold_sets(
        lambda: gla_case(g, B, S, H, dk, dv, dtype, shared)), calls=8,
        replays=3)
    work = gla_work(B, S, H, dk, dv, chunk, q.element_size(), shared)
    # the record's bound: the rate the kernel computes at, three TF32
    # products (3xTF32) a product on the tensor cores; beside it, printed
    # only, the bound of f32 on the CUDA cores
    tc_bound = bound_of(work[0], 3 * work[1], flops_per_s=TF32_FLOPS_PER_S)
    f32_bound = bound_of(*work, flops_per_s=F32_FLOPS_PER_S)
    L = min(chunk, S)
    n_chunks, n_qt = -(-S // L), -(-L // gl.TILE)
    hg = gl.head_group(q, k)
    print(f"  zamba2 mamba2 shape f32 (B={B} S={S} H={H} dk={dk} dv={dv} "
          f"chunk {chunk}, q and k broadcast, stride 0): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, no library call ({work[0]} bytes, "
          f"{work[1]} flops); grids: chunk states {n_chunks * H * B} blocks, "
          f"outputs {n_qt * n_chunks * H // hg * B} blocks ({hg} heads a "
          f"block) for the card's "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    print(f"  bounds: 3xTF32 on the tensor cores (3 x {work[1]} flops at "
          f"{TF32_FLOPS_PER_S:.3g} flop/s, the record's) {tc_bound[0]:.4f} "
          f"ms by {tc_bound[1]}, the kernel at "
          f"{tc_bound[0] / dev_ms * 100:.2f}% of it device-only; beside it "
          f"f32 on the CUDA cores ({F32_FLOPS_PER_S:.3g} flop/s) "
          f"{f32_bound[0]:.4f} ms by {f32_bound[1]}, the kernel at "
          f"{f32_bound[0] / dev_ms * 100:.2f}% of it")
    clocks("zamba2 mamba2 shape (3xTF32 bound)", ms, dev_ms, tc_bound)
    return record("gla", errs[(zamba, dtype)], ms, plain_ms, tc_bound, None,
                  dev_ms, None)


# Model-width shapes for the sweep over each tuning space's configs: the
# model's heads and head dim (or d_model), ragged against every tile.
SWEEP_DIMS = {
    "flash_attention": {"B": 1, "S": 320, "SK": 320, "H": 16, "KV": 16,
                        "D": 256},
    "decode_attention": {"B": 2, "S": 1000, "H": 16, "KV": 16, "D": 256},
    "paged_attention": {"B": 2, "S": 1000, "H": 16, "KV": 16, "D": 256},
    "rmsnorm": {"ROWS": 250, "D": 3072},
    "gla": {"B": 1, "S": 1000, "H": 8, "DK": 64, "DV": 64},  # Zamba2 heads
}


def lib_smem(kernel, cfg, d, dtype):
    """The shared memory of one block as the kernel's library reports it
    (the compiled kernel's static bytes, or the dynamic bytes its launcher
    asks for)."""
    code = build.DTYPE_CODE[dtype]
    if kernel == "flash_attention":
        return fa._lib().repro_flash_attention_smem_bytes(
            d["D"], code, min(cfg["block_q"], d["S"]),
            min(cfg["block_kv"], d["SK"]))
    if kernel == "decode_attention":
        return fd._lib().repro_flash_decode_smem_bytes(d["H"], d["KV"],
                                                       d["D"], code)
    if kernel == "paged_attention":
        return pa._lib().repro_paged_smem_bytes(d["H"], d["KV"], d["D"],
                                                code)
    if kernel == "gla":
        return gl._lib().repro_gla_smem_bytes(d["DK"], d["DV"],
                                              min(cfg["chunk"], d["S"]))
    return max(rn._lib().repro_rmsnorm_smem_bytes(code, code_s, vec)
               for code_s in {0, code} for vec in (0, 1))


def sweep_spaces():
    """Every config of each tuning space: the library's shared memory
    equals smem_footprint (both dtypes); each config the card's opt-in
    limit admits launches through the tuner's own call adapter at a
    Gemma-width shape, in each dtype, and agrees with the plain
    version."""
    limit = autotune.smem_limit(DEV)
    rng = np.random.default_rng(SEED)
    for kernel, dims in SWEEP_DIMS.items():
        kdef = autotune.KERNELS[kernel]
        space = autotune.KernelSpace(kernel).space()
        names = space.names
        grid = [dict(zip(names, vals)) for vals in itertools.product(
            *(space[n].choices for n in names))]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            for cfg in grid:
                want = kdef.smem_footprint(cfg, dims, dname)
                got = lib_smem(kernel, cfg, dims, dtype)
                check(got == want, f"{kernel} {cfg} {dname}: the library "
                                   f"reports {got} bytes of shared memory, "
                                   f"smem_footprint {want}")
        ran = {}
        for dname in ("bfloat16", "float32"):
            inputs = kdef.make_inputs(dims, dname, rng, DEV)
            if kernel == "flash_attention":
                want = attention_ref(*inputs)
            elif kernel == "decode_attention":
                want = fd.decode_attention_ref(*inputs)
            elif kernel == "paged_attention":
                want = fd.decode_attention_ref(inputs["q"], inputs["k"],
                                               inputs["v"], inputs["kv_len"])
            elif kernel == "gla":
                want = chunked_gla(*inputs)[0]
            else:
                want = rmsnorm_ref(*inputs)
            feasible = kernel_feasibility(kernel, dims, dname,
                                          smem_limit=limit)
            n_run = worst = 0
            for cfg in grid:
                if not feasible(cfg):
                    continue
                err = close(kdef.call(inputs, cfg), want,
                            f"{kernel} {cfg} {dname}",
                            scaled=kernel == "gla")
                worst = max(worst, err)
                n_run += 1
            ran[dname] = f"{n_run} in {dname} (max abs err {worst:.3e})"
            del inputs, want
        print(f"  {kernel} space: {len(grid)} configs, shared memory "
              f"equal to smem_footprint for each (bf16, f32); those that "
              f"fit the card's {limit} bytes a block launch and agree with "
              f"the plain version at {autotune.shape_sig(dims)}: "
              + ", ".join(ran.values()))


def phase_kernels():
    records = {"paged_flash_decode": kernels_paged(),
               "flash_attention": kernels_flash(),
               "flash_decode": kernels_decode(),
               "rmsnorm": kernels_rmsnorm(),
               "gla": kernels_gla()}
    sweep_spaces()
    return records


# ---------------------------------------------------------------------------
# phase 4: the port on the card against the port on the CPU
# ---------------------------------------------------------------------------
TINY = ModelConfig(
    name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32", vocab_pad_multiple=64,
    rope_theta=10_000.0,
)


# Phase 4's knob runs: (name, ServeConfig changes, workload).  Each knob
# runs on a workload that makes it act: "mixed" (random prompts longer
# than prefill_chunk=4, so interleave spreads their chunks), "heavy"
# (long generations on a 4-page pool: on_demand preempts), "cow" (a
# resident 32-token donor, an identical prompt and a 20-token prefix of
# it: coverage ends mid-group, so sharing splits groups copy-on-write)
PARITY_KNOBS = (
    ("fifo", {}, "mixed"),
    ("sjf", dict(schedule="sjf"), "mixed"),
    ("interleave", dict(schedule="interleave"), "mixed"),
    ("on_demand", dict(batch_slots=3, kv_cache_pages=4,
                       page_policy="on_demand"), "heavy"),
    ("share_prefix", dict(max_seq=64, share_prefix=True), "cow"),
    ("draft_len=3", dict(draft_len=3), "mixed"),
    ("temperature=0.8", dict(temperature=0.8, seed=7), "mixed"),
)
PARITY_COUNTS = ("steps", "prefill_chunks", "preemptions", "cow_splits",
                 "shared_prefix_tokens", "drafted", "accepted")


def parity_workloads(rng):
    lens, max_new = [5, 13, 3, 9], [6, 4, 8, 5]
    donor = rng.integers(1, TINY.vocab_size, size=32).tolist()
    return {
        "mixed": ([rng.integers(1, TINY.vocab_size, size=n).tolist()
                   for n in lens], max_new),
        "heavy": ([rng.integers(1, TINY.vocab_size, size=n).tolist()
                   for n in (3, 4, 5, 4, 3, 6)], [14, 12, 16, 13, 18, 12]),
        "cow": ([donor, [1, 2, 3], list(donor), donor[:20]],
                [26, 2, 5, 4]),
    }


def phase_parity():
    """Each knob's run on the card against the same run on the CPU (tiny
    model, f32): equal tokens and counts; the paged kernel launched
    n_layers times a single-token step, never on a verify step."""
    workloads = parity_workloads(np.random.default_rng(SEED))
    params = Model(TINY, device="cpu").init(SEED)
    base = dict(max_seq=32, batch_slots=2, kv_layout="paged",
                prefill_chunk=4)
    for name, knob, workload in PARITY_KNOBS:
        scfg = ServeConfig(**dict(base, **knob))
        outs = {}
        for label, d in (("cpu", "cpu"), ("card", DEV)):
            eng = ServeEngine(Model(TINY, device=d), params, scfg, device=d)
            before = pa.paged_flash_decode_cuda.launches
            outs[label] = eng.generate(*workloads[workload])
            launched = pa.paged_flash_decode_cuda.launches - before
            eng.last_alloc.check_balanced()
        card, cpu = outs["card"], outs["cpu"]
        check(card.tokens == cpu.tokens,
              f"{name}: tokens differ: card {card.tokens} vs cpu "
              f"{cpu.tokens}")
        counts_ = {c: (getattr(card, c), getattr(cpu, c))
                   for c in PARITY_COUNTS}
        check(all(a == b for a, b in counts_.values()),
              f"{name}: counts differ (card, cpu): {counts_}")
        single = 0 if scfg.draft_len else card.steps
        check(launched == TINY.n_layers * single,
              f"{name}: {launched} kernel launches for {single} "
              "single-token steps")
        check(card.preemptions > 0 or knob.get("page_policy") is None,
              f"{name}: the pool never ran dry")
        check(card.cow_splits > 0 or not knob.get("share_prefix"),
              f"{name}: no copy-on-write split")
        print(f"  {name}: tokens and counts equal on card and cpu; "
              + ", ".join(f"{c} {a}" for c, (a, _) in counts_.items())
              + f"; {launched} kernel launches")
    parity_retune(params)


# the online retuner on phase 4's tiny model: the reference test's
# drifting trace and retune settings (tests/test_workload_retune.py,
# _drift_workload and RETUNE_KW), anchored on a phase-A-only run
RETUNE_KW = dict(retune=True, retune_budget=8, retune_threshold=0.3,
                 retune_window=10, retune_cooldown=200,
                 retune_check_every=2, retune_min_requests=6)
RETUNE_EVENT_KEYS = ("step", "signature", "config", "applied",
                     "warm_source")


def drift_workload(vocab, prompt_scale=1, gen_scale=1, seed=0):
    """``_drift_workload``: 3 distinct prompts of 20 tokens (12 new each),
    then 12 of a shared 32-token prefix and 3 own tokens (6 new each),
    prompt lengths times ``prompt_scale``, generations times
    ``gen_scale``, tokens drawn below ``vocab``."""
    rng = np.random.default_rng(seed)
    pa_ = [rng.integers(1, vocab, size=20 * prompt_scale).tolist()
           for _ in range(3)]
    shared = rng.integers(1, vocab, size=32 * prompt_scale).tolist()
    pb = [shared + rng.integers(1, vocab, size=3 * prompt_scale).tolist()
          for _ in range(12)]
    return pa_ + pb, [12 * gen_scale] * 3 + [6 * gen_scale] * 12


def phase_a_signature(model, params, base, vocab, prompt_scale=1,
                      gen_scale=1, device=DEV, accept=True):
    """``_phase_a_sig``: the signature a stale offline winner was tuned
    under, from a run of 6 phase-A requests with the detector anchored
    but inert.  ``accept=False`` leaves its acceptance unset (``x?``), so
    ``fingerprint_distance`` skips that term."""
    from repro_torch.serve.workload import fingerprint_sig

    rng = np.random.default_rng(0)
    pa_ = [rng.integers(1, vocab, size=20 * prompt_scale).tolist()
           for _ in range(6)]
    eng = ServeEngine(model, params, ServeConfig(
        **base, retune=True, retune_threshold=10.0, retune_min_requests=6,
        retune_window=10), device=device)
    eng.generate(pa_, [12 * gen_scale] * 6)
    fp = eng.last_retuner.baseline
    return fingerprint_sig(fp if accept else replace(fp, accept_rate=math.nan))


def single_token_steps(res) -> int:
    """Decode steps that ran the paged kernel: all of them until a swap
    turns drafts on (every later step is a verify step)."""
    for ev in res.retunes:
        if "draft_len" in ev["applied"] and ev["applied"]["draft_len"][1]:
            return ev["step"]
    return res.steps


def parity_retune(params):
    """The drifting trace under retune, on the card and on the CPU: the
    tokens, every count and each retune event's step, signature, config,
    applied knobs and warm source must be equal (the card's winner keyed
    ``cuda-sm90``, the CPU's ``model-sm90``)."""
    base = dict(max_seq=48, batch_slots=8, kv_layout="paged",
                prefill_chunk=8, slot_cap=3)
    sig = {d: phase_a_signature(Model(TINY, device=d), params, base, 500,
                                device=d) for d in ("cpu", DEV)}
    check(sig["cpu"] == sig[DEV], f"phase-A signatures differ: {sig}")
    scfg = ServeConfig(**base, tuned_signature=sig["cpu"], **RETUNE_KW)
    outs = {}
    for d in ("cpu", DEV):
        eng = ServeEngine(Model(TINY, device=d), params, scfg, device=d)
        before = pa.paged_flash_decode_cuda.launches
        outs[d] = eng.generate(*drift_workload(500))
        launched = pa.paged_flash_decode_cuda.launches - before
        eng.last_alloc.check_balanced()
    card, cpu = outs[DEV], outs["cpu"]
    check(card.tokens == cpu.tokens, "retune: tokens differ on card and cpu")
    counts_ = {c: (getattr(card, c), getattr(cpu, c)) for c in PARITY_COUNTS}
    check(all(a == b for a, b in counts_.values()),
          f"retune: counts differ (card, cpu): {counts_}")
    events = [[{k: e[k] for k in RETUNE_EVENT_KEYS} for e in r.retunes]
              for r in (card, cpu)]
    check(events[0] == events[1],
          f"retune: events differ: card {events[0]} vs cpu {events[1]}")
    check(len(card.retunes) == 1 and card.retunes[0]["applied"],
          f"retune: {len(card.retunes)} retunes")
    single = single_token_steps(card)
    check(launched == TINY.n_layers * single,
          f"retune: {launched} kernel launches for {single} single-token "
          "steps")
    ev = card.retunes[0]
    print(f"  retune (anchor {sig['cpu']}): tokens, counts and events equal "
          f"on card and cpu; swap at step {ev['step']} of {card.steps} to "
          f"{ev['signature']}: " + ", ".join(
              f"{k} {a}->{b}" for k, (a, b) in ev["applied"].items())
          + f"; {launched} kernel launches")


# ---------------------------------------------------------------------------
# phase 5: Gemma-7B at full width
# ---------------------------------------------------------------------------
def prefill_logits(model, params, seq):
    """f32 logits over the true vocabulary after one chunked prefill of
    ``seq`` into a fresh pool (dense attention): the prediction for the
    token after ``seq``."""
    T = 16
    groups = -(-len(seq) // T)
    row = torch.arange(1, groups + 1, dtype=torch.int32, device=DEV)
    cache = model.init_paged_cache(groups + 1, T)
    logits, _ = model.prefill_chunk_slot_paged(
        params, {"tokens": torch.tensor([list(seq)], device=DEV)}, cache,
        row, 0)
    return logits[0, -1, :model.cfg.vocab_size].float()


def logit_consistency(model, params, prompt, generated):
    """Final logits of request ``prompt + generated[:-1]`` two ways:
    prefill of the prompt then one decode step per generated token (the
    paged decode kernel), against one chunked prefill of the whole
    sequence (dense attention).  Returns their Pearson correlation and
    their largest absolute difference."""
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
    a = dl[0, -1, :model.cfg.vocab_size].float()
    b = prefill_logits(model, params, list(prompt) + list(generated[:-1]))
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          "full-width logits not finite")
    return (float(torch.corrcoef(torch.stack([a, b]))[0, 1]),
            float((a - b).abs().max()))


def profile_step(step, what, annotate=(), steps=5):
    """Where one call of ``step`` goes on the card: host wall ms a call
    without the profiler, then device ms a call per kernel under
    ``torch.profiler`` and the idle share (the part of the unprofiled
    call during which no kernel ran).  ``annotate`` names functions of
    ``repro_torch.models.attention`` to wrap in ``record_function`` while
    profiling: each one's device ms a call is reported too.  Returns
    {kernel: device ms a call}, or None where the profiler saw no device
    events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import attention as attn_mod

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / steps * 1e3
    real = {name: getattr(attn_mod, name) for name in annotate}

    def wrap(name, fn):
        def annotated(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return annotated

    for name, fn in real.items():
        setattr(attn_mod, name, wrap(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(attn_mod, name, fn)
    # An annotation appears twice: on the host, with the device time of
    # the kernels it launched, and on the device timeline as a span of
    # its own, which is no kernel and must not count as busy time.  The
    # span is reported where the trace has it, else the kernels' sum.
    kernels, spans, launched = {}, {}, {}
    for e in prof.key_averages():
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if e.key in real:
            if on_card:
                spans[e.key] = e.self_device_time_total / 1e3 / steps
            else:
                launched[e.key] = getattr(
                    e, "device_time_total",
                    getattr(e, "cuda_time_total", 0.0)) / 1e3 / steps
            continue
        dt = getattr(e, "self_device_time_total", 0.0)
        if on_card and dt > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + dt / 1e3 / steps
    spans = {k: spans.get(k, launched.get(k, 0.0))
             for k in set(spans) | set(launched)}
    busy = sum(kernels.values())
    print(f"  {what}: {wall_ms:.4f} ms wall (no profiler)")
    if not kernels:
        print("  device time per kernel: not measured (the profiler saw "
              "no device events)")
        return None
    check(busy <= wall_ms, f"{what}: profiled device time {busy:.4f} ms "
                           f"exceeds the wall {wall_ms:.4f} ms")
    print(f"  device busy {busy:.4f} ms a call, idle share "
          f"{1 - busy / wall_ms:.3f}"
          + "".join(f"; {k} {ms:.4f} ms" for k, ms in spans.items())
          + "; top kernels (ms a call):")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {ms:.4f}  {key[:100]}")
    return kernels


def profile_decode_step(model, params, lengths, steps=5, columns=1):
    """``profile_step`` of one batched paged decode step at the cell's
    shape, with the device time split into GEMMs, the paged decode kernel
    and the rest.  ``columns`` > 1 profiles a verify step of that many
    tokens a slot."""
    T, maxg = 16, 2048 // 16
    B = len(lengths)
    need = [-(-(n + columns) // T) for n in lengths]
    table = torch.zeros((B, maxg), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(need):
        table[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    cache = model.init_paged_cache(nxt, T)
    table = table.to(DEV)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    feed = torch.ones((B, columns), dtype=torch.long, device=DEV)

    def step():
        logits, _ = model.decode_step_multi(params, feed, cache, lens, table)
        return logits.float().argmax(-1).cpu()

    what = "decode step" if columns == 1 else f"verify step ({columns} " \
        "columns)"
    kernels = profile_step(step, f"{what} at lengths {lengths}", steps=steps)
    if not kernels:
        return
    groups = {"gemm": 0.0, "paged_decode_kernel": 0.0, "other": 0.0}
    for key, ms in kernels.items():
        g = ("paged_decode_kernel" if "paged_decode_kernel" in key else
             "gemm" if any(w in key.lower() for w in ("gemm", "nvjet",
                                                      "cutlass", "xmma"))
             else "other")
        groups[g] += ms
    print("  by group (ms a call): "
          + ", ".join(f"{g} {ms:.4f}" for g, ms in groups.items()))


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

    reset_counts()
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
    corr, logit_err = logit_consistency(model, params, prompts[0],
                                        res.tokens[0])
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
          f"(min {MIN_LOGIT_CORR}), max abs difference {logit_err:.6f}")
    profile_decode_step(model, params, [int(n) + max_new // 2
                                        for n in plens])
    return model, params, prompts, max_new, res, launches, logit_err


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: ACTS tunes the four kernels at Gemma-7B width on the card
# ---------------------------------------------------------------------------
def library_fn(kernel, inputs):
    """One PyTorch call computing the kernel's function on the tuner's
    inputs (the layouts it wants are made here, outside the timing)."""
    if kernel == "flash_attention":
        q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in inputs)
        return lambda: sdpa(q4, k4, v4, is_causal=True)
    if kernel == "rmsnorm":
        x, s = inputs
        s_lib = s.to(x.dtype)
        return lambda: torch.nn.functional.rms_norm(
            x, (x.shape[-1],), weight=s_lib, eps=1e-6)
    if kernel == "paged_attention":
        q, k, v = inputs["q"], inputs["k"], inputs["v"]
    else:
        q, k, v, _ = inputs
    q4 = q[:, :, None, :]
    k4, v4 = (t.transpose(1, 2).contiguous() for t in (k, v))
    return lambda: sdpa(q4, k4, v4)  # the whole cache is valid


def work_of(kernel, d, esize):
    if kernel == "flash_attention":
        return flash_work(d["B"], d["S"], d["SK"], d["H"], d["KV"], d["D"],
                          esize)
    if kernel == "rmsnorm":
        return rms_work(d["ROWS"], d["D"], esize)
    nbytes, flops = decode_work(d["B"], d["H"], d["KV"], d["D"], d["S"],
                                esize)
    if kernel == "paged_attention":  # + the page table, one entry a group
        nbytes += d["B"] * 4 + d["B"] * (-(-d["S"] // 16)) * 4
    return nbytes, flops


def phase_tune():
    from repro_torch.launch.tune import main as tune_main

    cfg = get_config("gemma-7b")
    seq = SHAPES["train_4k"].seq_len
    reset_counts()
    t = time.perf_counter()
    rc = tune_main(["--arch", "gemma-7b", "--shape", "train_4k",
                    "--tune-kernels", "--kernel-budget", str(TUNE_BUDGET)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launched = counts()
    check(rc == 0, f"launch.tune exited {rc}")
    print(f"  launch.tune --tune-kernels (budget {TUNE_BUDGET} a kernel): "
          f"{seconds:.2f} s, launches {launched}")
    # the reference's launcher tunes these four (not gla)
    for name in ("paged_flash_decode", "flash_attention", "flash_decode",
                 "rmsnorm"):
        check(launched[name] > 0, f"the tune path never launched {name}")

    attn = {"B": 1, "S": seq, "H": cfg.n_heads, "KV": cfg.n_kv_heads,
            "D": cfg.head_dim_}
    dims_of = {"flash_attention": dict(attn, SK=seq),
               "decode_attention": attn, "paged_attention": attn,
               "rmsnorm": {"ROWS": seq, "D": cfg.d_model}}
    backend = autotune.backend_name(DEV)
    cache = autotune.default_cache()
    rng = np.random.default_rng(SEED)
    for kernel, dims in dims_of.items():
        sig = autotune.shape_sig(dims)
        entry = cache.get(kernel, sig, cfg.compute_dtype, backend)
        check(entry is not None, f"no {kernel} entry under {backend}")
        winner = entry["config"]
        default = autotune.KernelSpace(kernel).space().default_config()
        # the entry points resolve the winner for this shape and card
        resolvable = [k for k in winner if k != "pages_per_block"]
        got = ops._resolve(kernel, dims, torch.bfloat16, DEV,
                           {k: None for k in resolvable})
        check(all(got[k] == winner[k] for k in resolvable),
              f"ops resolves {got} for {kernel}, the tuned entry is "
              f"{winner}")
        kdef = autotune.KERNELS[kernel]
        inputs = kdef.make_inputs(dims, cfg.compute_dtype, rng, DEV)
        runs = 5 if kernel == "flash_attention" else 30
        d_ms = time_ms(lambda: kdef.call(inputs, default), runs=runs)
        w_ms = time_ms(lambda: kdef.call(inputs, winner), runs=runs)
        lib_ms = time_ms(library_fn(kernel, inputs), runs=runs)
        bound = bound_of(*work_of(kernel, dims, 2))
        print(f"  {kernel} {sig} bf16: default {default} {d_ms:.4f} ms, "
              f"winner {winner} {w_ms:.4f} ms (tuner's min "
              f"{entry['meta']['default_value'] * 1e3:.4f} -> "
              f"{entry['value'] * 1e3:.4f} ms in "
              f"{entry['meta']['n_tests']} tests, "
              f"{entry['meta']['n_infeasible_pruned']} pruned), bound "
              f"{bound[0]:.4f} ms by {bound[1]}, library {lib_ms:.4f} ms")
        # the whole space on the card, by both clocks (the device-only
        # one on a single input set: a ranking, not an L2-cold figure):
        # how close the tuner's budget got to the grid's best
        feasible = kernel_feasibility(kernel, dims, cfg.compute_dtype,
                                      smem_limit=autotune.smem_limit(DEV))
        space = autotune.KernelSpace(kernel).space()
        grids = {"host-paced": {}, "device-only": {}}
        for vals in itertools.product(*(space[n].choices
                                        for n in space.names)):
            c = dict(zip(space.names, vals))
            if feasible(c):
                grids["host-paced"][vals] = time_ms(
                    lambda: kdef.call(inputs, c), runs=10, warmup=1)
                grids["device-only"][vals] = device_ms(
                    lambda: kdef.call(inputs, c), [()], calls=16, replays=2)
        for clock, grid in grids.items():
            ranked = sorted(grid.values())
            best = min(grid, key=grid.get)
            won = grid[tuple(winner[n] for n in space.names)]
            dflt = grid[tuple(default[n] for n in space.names)]
            if kernel == "flash_attention":  # the whole ranking: PERF.md
                print(f"    flash grid, {clock} (ms): " + ", ".join(
                    f"{dict(zip(space.names, c))} {t:.4f}"
                    for c, t in sorted(grid.items(), key=lambda kv: kv[1])))
            print(f"    grid, {clock}: {len(grid)} configs fit; best "
                  f"{dict(zip(space.names, best))} {grid[best]:.4f} ms, "
                  f"median {statistics.median(ranked):.4f}, worst "
                  f"{ranked[-1]:.4f}; the winner {won:.4f} ms ranks "
                  f"{ranked.index(won) + 1} of {len(grid)} "
                  f"({won / grid[best]:.3f}x the best), the default "
                  f"{dflt:.4f} ms ({dflt / grid[best]:.3f}x)")
        del inputs
    return launched


# ---------------------------------------------------------------------------
# phase 7: Gemma-7B served with kernel autotune, on the phase-6 cache
# ---------------------------------------------------------------------------
def phase_autotune_serve(model, params, prompts, max_new, untuned):
    cfg = model.cfg
    reset_counts()
    t = time.perf_counter()
    engine = ServeEngine(model, params, ServeConfig(
        max_seq=2048, batch_slots=8, kv_layout="paged",
        autotune_kernels=True), device=DEV)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t
    at_build = counts()
    res = engine.generate(prompts, max_new)
    launched = counts()
    decode_launches = (launched["paged_flash_decode"]
                       - at_build["paged_flash_decode"])
    print(f"  engine build with autotune_kernels: {tune_s:.2f} s, "
          f"launches while tuning {at_build}; after serving {launched}")
    check(at_build["flash_decode"] > 0,
          "the engine's decode_attention warm-up never launched its kernel")
    check(decode_launches == cfg.n_layers * res.steps,
          f"{decode_launches} paged decode launches for {res.steps} steps")
    tuned = engine.kernel_blocks["paged_attention"]
    check(engine.group_pages == tuned["pages_per_block"],
          f"group size {engine.group_pages} pages, tuned "
          f"{tuned['pages_per_block']}")
    for toks in res.tokens:
        check(len(toks) == max_new and all(0 <= t < cfg.vocab_size
                                           for t in toks),
              "autotuned serve returned a malformed continuation")
    engine.last_alloc.check_balanced()
    agree = sum(a == b for ta, tb in zip(res.tokens, untuned.tokens)
                for a, b in zip(ta, tb))
    total = sum(len(t) for t in res.tokens)
    print(f"  adopted group size {engine.group_pages} pages "
          f"({engine.group_tokens} tokens), pool {engine.pool_groups} "
          f"groups; decode_attention tuned "
          f"{engine.kernel_blocks['decode_attention']}")
    print(f"  serve: decode {res.decode_tokens_per_sec:.2f} tok/s tuned vs "
          f"{untuned.decode_tokens_per_sec:.2f} untuned (phase 5), "
          f"{res.steps} steps, {decode_launches} decode launches; "
          f"{agree} of {total} tokens equal to the untuned run's")
    return launched


# ---------------------------------------------------------------------------
# phase 9: the serve knobs on Gemma-7B at full width
# ---------------------------------------------------------------------------
def knob_workloads(prompts, max_new, vocab):
    """Phase 9's runs: (name, ServeConfig changes, workload), and the
    workloads {name: (prompts, max_new)}.  "phase5" is phase 5's 8
    requests.  The on_demand pool holds every phase-5 prompt (+ the
    scratch group) but not every prompt + max_new, so decode must grow
    reservations and preempt.  "shared": 7 prompts of a common 264-token
    prefix (16.5 groups) and distinct suffixes of 64 to 256 tokens, and
    an 8th that repeats the 512-token one.  The registry matches whole
    16-token groups of resident prompts, so the distinct suffixes share
    256 tokens each and split nothing; the repeat matches all 32 groups
    of its twin, is capped one token short (that token's logits seed its
    first sample), so its first write lands mid-group and forces a
    copy-on-write split.  At prefill_chunk 512 the 520-token prompt
    takes 2 chunks unshared and 1 shared."""
    rng = np.random.default_rng(SEED + 9)
    common = rng.integers(1, vocab, size=256 + 8).tolist()
    shared = [common + rng.integers(1, vocab, size=n).tolist()
              for n in (64, 96, 128, 160, 192, 248, 256)]
    shared.append(list(shared[5]))
    pages = sum(-(-len(p) // 16) for p in prompts) + 1
    worst = sum(-(-(len(p) + max_new) // 16) for p in prompts) + 1
    check(pages < worst, f"on_demand pool of {pages} pages holds every "
                         f"worst case ({worst})")
    runs = (
        ("sjf", dict(schedule="sjf"), "phase5"),
        ("interleave", dict(schedule="interleave", prefill_chunk=128),
         "phase5"),
        ("on_demand", dict(page_policy="on_demand", kv_cache_pages=pages),
         "phase5"),
        ("unshared", {}, "shared"),
        ("share_prefix", dict(share_prefix=True), "shared"),
        ("draft_len=4", dict(draft_len=4), "phase5"),
        ("temperature=0.8 fifo", dict(temperature=0.8), "phase5"),
        ("temperature=0.8 sjf", dict(temperature=0.8, schedule="sjf"),
         "phase5"),
    )
    return runs, {"phase5": (prompts, max_new), "shared": (shared, max_new)}


def first_divergences(model, params, prompts, base, got,
                      logits_of=prefill_logits):
    """Requests whose tokens equal the baseline's, and for each other one
    (request, position, the baseline's top-2 logit gap there): the gap
    from a prefill (``logits_of``) of prompt + the baseline's tokens
    before it."""
    same, diverged = 0, []
    for i, (a, b) in enumerate(zip(base, got)):
        if a == b:
            same += 1
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = torch.topk(logits_of(model, params,
                                    list(prompts[i]) + a[:j]), 2).values
        diverged.append((i, j, float(top2[0] - top2[1])))
    return same, diverged


def phase_knobs(model, params, prompts, max_new, baseline, logit_err,
                card):
    """Each knob of the live co-tuner's space, one at a time, on phase 5's
    engine config at full width: every run leaves the pool balanced and
    launches the paged kernel n_layers times a single-token step (none on
    a verify step); greedy tokens are compared with the fifo/reserve
    baseline on the same prompts, and a divergence must sit at a top-2
    logit gap within DIVERGE_GAP_FACTOR x phase 5's logit error."""
    cfg = model.cfg
    runs, workloads = knob_workloads(prompts, max_new, cfg.vocab_size)
    bar = DIVERGE_GAP_FACTOR * logit_err
    print(f"  {card}; divergence bar: top-2 gap <= {DIVERGE_GAP_FACTOR} x "
          f"{logit_err:.6f} = {bar:.6f}")
    results = {"fifo": baseline}
    for name, knob, workload in runs:
        engine = ServeEngine(model, params, ServeConfig(
            max_seq=2048, batch_slots=8, kv_layout="paged", **knob),
            device=DEV)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        res = engine.generate(*workloads[workload])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = pa.paged_flash_decode_cuda.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        engine.last_alloc.check_balanced()
        results[name] = res
        for toks in res.tokens:
            check(len(toks) == max_new
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{name}: a malformed continuation")
        single = 0 if engine.cfg.draft_len else res.steps
        check(launches == cfg.n_layers * single,
              f"{name}: {launches} paged launches for {single} "
              "single-token decode steps")
        host_s = wall - res.prefill_seconds - res.decode_seconds
        print(f"  {name}: {res.steps} steps, {res.prefill_chunks} prefill "
              f"chunks, {res.preemptions} preemptions, {res.cow_splits} CoW "
              f"splits, {res.shared_prefix_tokens} shared tokens, drafted "
              f"{res.drafted} accepted {res.accepted}; {launches} paged "
              f"launches; decode {res.decode_tokens_per_sec:.2f} tok/s "
              f"({res.decode_seconds / max(res.steps, 1) * 1e3:.4f} ms a "
              f"step), prefill {res.prefill_seconds:.4f} s, host outside "
              f"dispatches {host_s:.4f} s, p50 {res.p50_latency_s:.4f} s, p95 "
              f"{res.p95_latency_s:.4f} s, peak {peak_gb:.2f} GB")
        if knob.get("temperature"):
            continue
        base = results["unshared" if workload == "shared" else "fifo"]
        if base is res:
            continue
        same, diverged = first_divergences(
            model, params, workloads[workload][0], base.tokens, res.tokens)
        print(f"    {same} of {len(res.tokens)} requests equal the "
              f"{'unshared' if workload == 'shared' else 'fifo/reserve'} "
              "baseline; first divergences (request, token, top-2 gap): "
              + (", ".join(f"({i}, {j}, {g:.6f})" for i, j, g in diverged)
                 or "none"))
        for i, j, g in diverged:
            check(g <= bar, f"{name}: request {i} diverges at token {j} "
                            f"where the top-2 gap {g:.6f} > {bar:.6f}")
    check(results["on_demand"].preemptions > 0,
          "on_demand: the pool never ran dry")
    sh, un = results["share_prefix"], results["unshared"]
    check(sh.shared_prefix_tokens > 0 and sh.cow_splits > 0,
          f"share_prefix: {sh.shared_prefix_tokens} shared tokens, "
          f"{sh.cow_splits} CoW splits")
    check(sh.prefill_chunks < un.prefill_chunks,
          f"share_prefix: {sh.prefill_chunks} prefill chunks, unshared "
          f"{un.prefill_chunks}")
    check(results["temperature=0.8 fifo"].tokens
          == results["temperature=0.8 sjf"].tokens,
          "temperature: fifo and sjf sampled different tokens")
    print("  temperature=0.8: fifo and sjf sampled the same tokens")
    profile_decode_step(model, params, [len(p) + max_new // 2
                                        for p in prompts], columns=5)


# ---------------------------------------------------------------------------
# phase 11: online retuning on Gemma-7B at full width
# ---------------------------------------------------------------------------
# phase 4's drifting trace at Gemma-7B scale: prompt lengths x16 (phase A
# 320 tokens, phase B a 512-token shared prefix + 48 own), generations x4
# (48 and 24 new tokens)
RETUNE_PROMPT_SCALE = 16
RETUNE_GEN_SCALE = 4
RETUNE_BASE = dict(max_seq=1024, batch_slots=8, kv_layout="paged",
                   prefill_chunk=128, slot_cap=3)
# the lengths a decode step of that trace gives the paged kernel: phase A's
# 320-token prompts plus 0 to 48 generated, phase B's 560 plus 0 to 24
PAGED_RETUNE_LENGTHS = [321, 344, 368, 561, 572, 584, 330, 575]


def timed_dispatches(model, capture_when):
    """Wrap ``model.decode_step_multi`` (on this instance) to record each
    dispatch: (seconds to a device sync, columns, slots holding a
    request), and ``ops.paged_flash_decode`` to keep clones of the inputs
    and output of the first layer's call in the first single-token
    dispatch whose host lengths satisfy ``capture_when``.  Returns the
    record list, the capture list and the undo."""
    log, kept, armed = [], [], []
    real = model.decode_step_multi
    real_op = ops.paged_flash_decode

    def wrapped(params, tokens, cache, lengths, page_table):
        if (not kept and tokens.shape[1] == 1
                and capture_when(lengths.tolist())):
            armed.append(True)
        t = time.perf_counter()
        out = real(params, tokens, cache, lengths, page_table)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t, tokens.shape[1],
                    int((lengths > 0).sum())))
        armed.clear()
        return out

    def op(q, k_pages, v_pages, page_table, lengths):
        out = real_op(q, k_pages, v_pages, page_table, lengths)
        if armed and not kept:
            kept.append([t.clone() for t in (q, k_pages, v_pages,
                                             page_table, lengths, out)])
        return out

    def undo():
        del model.decode_step_multi
        ops.paged_flash_decode = real_op

    model.decode_step_multi = wrapped
    ops.paged_flash_decode = op
    return log, kept, undo


def phase_retune(model, params, logit_err, card):
    """The online retuner at full width: the drifting trace served with
    retune on phase 5's model.  At least one swap must fire past the
    threshold with knobs applied and a finite measured acceptance; the
    pool must end balanced; the paged kernel must run n_layers times a
    single-token step; the winner must read back from the run's cache
    under the card's key at its signature.  Greedy tokens are compared
    with the same trace served without retune (a new max_batch changes
    the batch composition, so bf16 rounding can move): a divergence must
    sit at a top-2 logit gap within DIVERGE_GAP_FACTOR x phase 5's logit
    error.  Records: each retune's host seconds, and decode tok/s before
    and after the swap."""
    from repro_torch.serve import workload

    cfg = model.cfg
    t_phase = time.perf_counter()
    # the anchor leaves acceptance unset: before a swap it comes from the
    # one-token n-gram probe against greedy bf16 tokens, which rounding can
    # move, and the first check past the threshold clears it by a few
    # thousandths (the distance climbs about 0.005 a check).  Without it
    # the trigger reads only the trace's shape (arrivals, lengths, depth,
    # spread, share), so the swap step is the same on every run
    sig = phase_a_signature(model, params, RETUNE_BASE, cfg.vocab_size,
                            RETUNE_PROMPT_SCALE, RETUNE_GEN_SCALE,
                            accept=False)
    prompts, max_new = drift_workload(cfg.vocab_size, RETUNE_PROMPT_SCALE,
                                      RETUNE_GEN_SCALE)
    base = ServeEngine(model, params, ServeConfig(**RETUNE_BASE),
                       device=DEV).generate(prompts, max_new)
    retune_s = []
    real_retune = workload.OnlineRetuner.retune

    def timed_retune(self, *a, **kw):
        t = time.perf_counter()
        out = real_retune(self, *a, **kw)
        retune_s.append(time.perf_counter() - t)
        return out

    engine = ServeEngine(model, params, ServeConfig(
        **RETUNE_BASE, tuned_signature=sig, **RETUNE_KW), device=DEV)
    # a phase-B request (560 prompt tokens) resident beside another
    log, kept, undo = timed_dispatches(
        model, lambda ln: max(ln) >= 560 and sum(n > 0 for n in ln) >= 2)
    workload.OnlineRetuner.retune = timed_retune
    try:
        reset_counts()
        res = engine.generate(prompts, max_new)
        launches = counts()
    finally:
        workload.OnlineRetuner.retune = real_retune
        undo()
    engine.last_alloc.check_balanced()
    check(engine.last_alloc.groups_in_use == 0, "retune: pages left in use")
    for toks, m in zip(res.tokens, max_new):
        check(len(toks) == m and all(0 <= t < cfg.vocab_size for t in toks),
              "retune: a malformed continuation")
    check(len(res.retunes) >= 1, f"retune: no swap fired (anchor {sig})")
    for ev in res.retunes:
        check(ev["distance"] > RETUNE_KW["retune_threshold"]
              and ev["applied"],
              f"retune: event at step {ev['step']}: distance "
              f"{ev['distance']:.4f}, applied {ev['applied']}")
        check(math.isfinite(ev["measured_accept"]),
              f"retune: measured acceptance {ev['measured_accept']}")
        got = autotune.serve_config_candidates(
            {"S": RETUNE_BASE["max_seq"], "H": cfg.n_heads,
             "KV": cfg.n_kv_heads, "D": cfg.head_dim_}, cfg.compute_dtype,
            backend="cuda-sm90").get(ev["signature"])
        check(got is not None and got["config"] == ev["config"]
              and got["meta"]["source"] == "online_retune",
              f"retune: the winner at {ev['signature']} reads back as "
              f"{got}")
    single = single_token_steps(res)
    check(launches["paged_flash_decode"] == cfg.n_layers * single,
          f"retune: {launches['paged_flash_decode']} paged launches for "
          f"{single} single-token steps")
    check(len(log) == res.steps, f"{len(log)} dispatches, {res.steps} steps")
    # one captured call of the main path against the plain version (after
    # the counts were read): a fresh launch on its inputs must equal what
    # the run computed bit for bit, and the plain version within TOL on
    # the rows holding a request (an empty row is zeros by the kernel's
    # contract, the plain version's softmax over no keys is not)
    check(len(kept) == 1, "retune: no single-token step held a phase-B "
                          "request beside another")
    q, kp, vp, pt, ln, ran = kept.pop()
    fresh = pa.paged_flash_decode_cuda(q, kp, vp, pt, ln)
    check(torch.equal(fresh, ran), "retune: a fresh launch on the captured "
                                   "inputs differs from the run's output")
    rows = ln > 0
    err, rel = paged_close(fresh[rows], pa.paged_attention_ref(
        q, kp, vp, pt, ln)[rows], ln[rows], "retune: captured paged call")
    print(f"  captured paged call (B={q.shape[0]}, {kp.shape[0]} groups of "
          f"{kp.shape[1]}, {pt.shape[1]} a slot, lengths {ln.tolist()}): "
          f"equal to a fresh launch bit for bit; max abs err {err:.3e} "
          f"(tol {TOL[q.dtype]}), norm-relative err {rel:.3e} over the rows "
          f"of {PAGED_LONG} tokens or more (bar {FLASH_REL_TOL[q.dtype]})")
    del q, kp, vp, pt, ln, ran, fresh
    same, diverged = first_divergences(model, params, prompts, base.tokens,
                                       res.tokens)
    bar = DIVERGE_GAP_FACTOR * logit_err
    for i, j, g in diverged:
        check(g <= bar, f"retune: request {i} diverges at token {j} where "
                        f"the top-2 gap {g:.6f} > {bar:.6f}")
    # records: decode tok/s before and after the first swap (tokens of a
    # dispatch: one a decoding slot before it; after it, the rest of the
    # decoded tokens: all tokens less one a prefill completion)
    k = res.retunes[0]["step"]
    before_tok = sum(n for _, _, n in log[:k])
    before_s = sum(t for t, _, _ in log[:k])
    decoded = (sum(len(t) for t in res.tokens) - len(prompts)
               - res.preemptions)
    after_s = sum(t for t, _, _ in log[k:])
    print(f"  {card}; anchor {sig}; {len(prompts)} requests, prompts "
          f"{sorted(set(len(p) for p in prompts))}, max_new "
          f"{sorted(set(max_new))}")
    for ev, sec in zip(res.retunes, retune_s):
        print(f"  retune @step {ev['step']} of {res.steps}: distance "
              f"{ev['distance']:.4f} -> {ev['signature']} "
              f"[{ev['warm_source']}], {ev['n_tests']} tests in {sec:.4f} s "
              f"host, surrogate value {ev['value']:.2f}, measured accept "
              f"{ev['measured_accept']:.4f} (spec_accept "
              f"{ev['spec_accept']:.4f}); applied " + ", ".join(
                  f"{kn} {a}->{b}" for kn, (a, b) in ev["applied"].items()))
    print(f"  with retune: {res.steps} steps ({single} single-token), "
          f"{res.prefill_chunks} prefill chunks, {res.preemptions} "
          f"preemptions, {res.shared_prefix_tokens} shared tokens, drafted "
          f"{res.drafted} accepted {res.accepted}; launches {launches}; "
          f"decode {res.decode_tokens_per_sec:.2f} tok/s over the run; "
          f"before the swap {before_tok} tokens in {before_s:.4f} s = "
          f"{before_tok / max(before_s, 1e-9):.2f} tok/s, "
          f"{before_s / max(k, 1) * 1e3:.4f} ms a step; after it "
          f"{decoded - before_tok} tokens in {after_s:.4f} s = "
          f"{(decoded - before_tok) / max(after_s, 1e-9):.2f} tok/s, "
          f"{after_s / max(res.steps - k, 1) * 1e3:.4f} ms a step")
    print(f"  without retune: {base.steps} steps, {base.prefill_chunks} "
          f"prefill chunks, decode {base.decode_tokens_per_sec:.2f} tok/s; "
          f"{same} of {len(prompts)} requests equal it; first divergences "
          "(request, token, top-2 gap): "
          + (", ".join(f"({i}, {j}, {g:.6f})" for i, j, g in diverged)
             or "none") + f" (bar {bar:.6f})")
    print(f"  phase 11: {time.perf_counter() - t_phase:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# phases 13 and 14: the dense layout, the wave runtime, Zamba2 serving
# ---------------------------------------------------------------------------
def capture_flash():
    """Wrap ``ops.flash_attention`` to keep clones of the inputs and output
    of its first call and the shapes of every call.  Returns (kept,
    shapes, undo)."""
    kept, shapes = [], []
    real = ops.flash_attention

    def op(q, k, v, **kw):
        out = real(q, k, v, **kw)
        shapes.append(tuple(q.shape))
        if not kept:
            kept.append(([t.clone() for t in (q, k, v, out)], kw))
        return out

    def undo():
        ops.flash_attention = real

    ops.flash_attention = op
    return kept, shapes, undo


def check_captured_flash(kept, what):
    """Relaunch a captured flash call on its inputs (bit for bit the run's
    output) and hold it to the plain version within TOL and the
    norm-relative FLASH_REL_TOL."""
    (q, k, v, ran), kw = kept.pop()
    fresh = ops.flash_attention(q, k, v, **kw)
    check(torch.equal(fresh, ran), f"{what}: a fresh launch on the captured "
                                   "inputs differs from the run's output")
    want = attention_ref(q, k, v, **kw)
    err = close(fresh, want, f"{what}: captured flash call")
    rel = rel_err(fresh, want)
    check(rel <= FLASH_REL_TOL[q.dtype],
          f"{what}: captured flash call norm-relative error {rel:.3e}")
    print(f"  captured flash call (q {tuple(q.shape)}, k {tuple(k.shape)}, "
          f"{q.dtype}): equal to a fresh launch bit for bit; max abs err "
          f"{err:.3e} (tol {TOL[q.dtype]}), norm-relative err {rel:.3e} "
          f"(bar {FLASH_REL_TOL[q.dtype]})")
    return err


def dense_prefill_logits(model, params, seq):
    """``prefill_logits`` for a stack without a paged layout: one
    whole-prompt ``Model.prefill`` of ``seq`` into a fresh dense cache."""
    logits, _ = model.prefill(
        params, {"tokens": torch.tensor([list(seq)], device=model.device)},
        model.init_cache(1, len(seq)))
    return logits[0, -1, :model.cfg.vocab_size].float()


def divergence_report(model, params, prompts, base, got, bar, what,
                      logits_of=prefill_logits):
    """Phase 9's divergence rule: requests equal to the baseline's, and
    each other one's first divergence must sit at a top-2 logit gap
    (``first_divergences``) within ``bar``.  Returns the line to print."""
    same, diverged = first_divergences(model, params, prompts, base, got,
                                       logits_of)
    for i, j, g in diverged:
        check(g <= bar, f"{what}: request {i} diverges at token {j} where "
                        f"the top-2 gap {g:.6f} > {bar:.6f}")
    return f"{same} of {len(got)} requests equal; first divergences " \
        "(request, token, top-2 gap): " + (", ".join(
            f"({i}, {j}, {g:.6f})" for i, j, g in diverged) or "none") + \
        f" (bar {bar:.6f})"


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(cache["blocks"]))


WAVE_PROMPT, WAVE_NEW = 512, 32


def phase_dense_wave(model, params, prompts, max_new, paged, logit_err,
                     card):
    """Phase 13 on phase 5's model: (a) phase 5's requests on the dense
    layout; (b) a wave of 8 512-token prompts under attn_impl="pallas"
    (the flash kernel once a layer in prefill, never in decode; the first
    call captured and held to the plain version; tokens against the plain
    attention's); (c) that wave at prefill_chunk 128 (4 chunks, no flash
    launch); (d) that wave with autotune_kernels on phase 6's cache.
    Returns the flash launches of (b)."""
    cfg = model.cfg
    L = cfg.n_layers
    bar = DIVERGE_GAP_FACTOR * logit_err
    t_phase = time.perf_counter()
    print(f"  {card}")
    # (a) the dense layout on phase 5's requests and engine config
    engine = ServeEngine(model, params, ServeConfig(
        max_seq=2048, batch_slots=8, kv_layout="dense"), device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = engine.generate(prompts, max_new)
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["paged_flash_decode"] == 0,
          f"dense: {launches['paged_flash_decode']} paged launches")
    check(engine.last_alloc is None, "dense: an allocator ran")
    check((res.steps, res.prefill_chunks) == (paged.steps,
                                              paged.prefill_chunks),
          f"dense: {res.steps} steps, {res.prefill_chunks} chunks; paged "
          f"{paged.steps}, {paged.prefill_chunks}")
    for toks in res.tokens:
        check(len(toks) == max_new and all(0 <= t < cfg.vocab_size
                                           for t in toks),
              "dense: a malformed continuation")
    against = divergence_report(model, params, prompts, paged.tokens,
                                res.tokens, bar, "dense")
    cache = model.init_cache(8, 2048)
    del cache["index"]
    esize = cache["blocks"][0]["k"].element_size()
    dense_bytes = cache_bytes(cache)
    check(dense_bytes == 2 * 8 * 2048 * cfg.n_kv_heads * cfg.head_dim_
          * esize * L, f"dense cache {dense_bytes} bytes")
    print(f"  (a) dense layout, phase 5's requests: {res.steps} steps, "
          f"{res.prefill_chunks} prefill chunks (paged: {paged.steps}, "
          f"{paged.prefill_chunks}); launches {launches}; decode "
          f"{res.decode_tokens_per_sec:.2f} tok/s "
          f"({res.decode_seconds / max(res.steps, 1) * 1e3:.4f} ms a step; "
          f"paged {paged.decode_tokens_per_sec:.2f}), prefill "
          f"{res.prefill_seconds:.4f} s, peak {peak_gb:.2f} GB, dense "
          f"cache {dense_bytes} bytes (8 x 2048 x {L} layers, {esize}-byte"
          " elements)")
    print(f"    against phase 5's paged run: {against}")
    del engine
    lengths = [len(p) + max_new // 2 for p in prompts]
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    feed = torch.ones((8, 1), dtype=torch.long, device=DEV)

    def dense_step():
        logits, _ = model.decode_step_multi(params, feed, cache, lens)
        return logits.float().argmax(-1).cpu()

    profile_step(dense_step, f"dense decode step at lengths {lengths}",
                 annotate=("_dense_attend",))
    del cache

    # (b) the wave runtime, whole-prompt prefill through the flash kernel
    rng = np.random.default_rng(SEED + 13)
    wave = rng.integers(1, cfg.vocab_size, size=(8, WAVE_PROMPT)).tolist()
    pallas = Model(replace(cfg, attn_impl="pallas"), device=DEV)
    wave_cfg = dict(max_seq=1024, batch_slots=8, runtime="wave")
    eng = ServeEngine(pallas, params, ServeConfig(**wave_cfg), device=DEV)
    kept, shapes, undo = capture_flash()
    try:
        reset_counts()
        wres = eng.generate(wave, WAVE_NEW)
        wl = counts()
    finally:
        undo()
    check(wres.prefill_chunks == 1 and wl["flash_attention"] == L,
          f"wave: {wl['flash_attention']} flash launches, "
          f"{wres.prefill_chunks} prefill dispatches (expected {L}, 1)")
    check(set(shapes) == {(8, WAVE_PROMPT, cfg.n_heads, cfg.head_dim_)},
          f"wave: flash shapes {set(shapes)}")
    check(wl["paged_flash_decode"] == 0, f"wave: launches {wl}")
    for toks in wres.tokens:
        check(len(toks) == WAVE_NEW and all(0 <= t < cfg.vocab_size
                                            for t in toks),
              "wave: a malformed continuation")
    check_captured_flash(kept, "wave")
    plain = Model(replace(cfg, attn_impl="auto"), device=DEV)
    pres = ServeEngine(plain, params, ServeConfig(**wave_cfg),
                       device=DEV).generate(wave, WAVE_NEW)
    print(f"  (b) wave, 8 x {WAVE_PROMPT} tokens, attn_impl=pallas: "
          f"prefill {wres.prefill_seconds:.4f} s "
          f"({8 * WAVE_PROMPT / wres.prefill_seconds:.1f} tok/s), decode "
          f"{wres.decode_tokens_per_sec:.2f} tok/s, {wres.steps} steps; "
          f"launches {wl}; plain attention (auto: dense at S={WAVE_PROMPT})"
          f" prefill {pres.prefill_seconds:.4f} s")
    print("    against the plain attention's wave: " + divergence_report(
        model, params, wave, pres.tokens, wres.tokens, bar, "wave"))

    # (c) the same wave in 128-token chunks: dense attention, no flash
    reset_counts()
    cres = ServeEngine(pallas, params, ServeConfig(
        **wave_cfg, prefill_chunk=128), device=DEV).generate(wave, WAVE_NEW)
    cl = counts()
    check(cres.prefill_chunks == WAVE_PROMPT // 128
          and cl["flash_attention"] == 0,
          f"chunked wave: {cres.prefill_chunks} chunks, launches {cl}")
    print(f"  (c) wave at prefill_chunk 128: {cres.prefill_chunks} chunks, "
          f"prefill {cres.prefill_seconds:.4f} s, launches {cl}; against "
          "(b): " + divergence_report(model, params, wave, wres.tokens,
                                     cres.tokens, bar, "chunked wave"))

    # (d) the wave with autotune_kernels on phase 6's cache
    calls = []
    real_cuda = ops.flash_attention_cuda

    def spy(q, k, v, **kw):
        calls.append((kw["block_q"], kw["block_kv"]))
        return real_cuda(q, k, v, **kw)

    t = time.perf_counter()
    teng = ServeEngine(pallas, params, ServeConfig(
        **wave_cfg, autotune_kernels=True), device=DEV)
    # the warm-up generate() runs first, here, so that its tuning
    # launches stay out of the wave's counts (in generate it hits the
    # cache)
    teng._warm_prefill_blocks(WAVE_PROMPT)
    ops.flash_attention_cuda = spy
    try:
        reset_counts()
        tres = teng.generate(wave, WAVE_NEW)
        tl = counts()
    finally:
        ops.flash_attention_cuda = real_cuda
    tune_s = time.perf_counter() - t
    dims = {"B": 8, "S": WAVE_PROMPT, "SK": WAVE_PROMPT, "H": cfg.n_heads,
            "KV": cfg.n_kv_heads, "D": cfg.head_dim_}
    win = autotune.cached_blocks("flash_attention", dims, cfg.compute_dtype,
                                 backend="cuda-sm90")
    check(win is not None and win == teng.kernel_blocks["flash_attention"],
          f"autotune: flash winner {win}, engine "
          f"{teng.kernel_blocks.get('flash_attention')}")
    for key, rows in (("rmsnorm_prefill", 8 * WAVE_PROMPT),
                      ("rmsnorm_decode", 8)):
        got = autotune.cached_blocks("rmsnorm", {"ROWS": rows,
                                                 "D": cfg.d_model},
                                     cfg.compute_dtype, backend="cuda-sm90")
        check(got is not None and got == teng.kernel_blocks[key],
              f"autotune: {key} {got}")
    check(len(calls) == L and set(calls) == {(win["block_q"],
                                              win["block_kv"])},
          f"autotune: the wave's flash calls ran {set(calls)}, winner "
          f"{win}")
    print(f"  (d) wave with autotune_kernels: engine build + serve "
          f"{tune_s:.2f} s; flash winner {win} at {dims} (cuda-sm90), "
          f"RMSNorm {teng.kernel_blocks['rmsnorm_prefill']} / "
          f"{teng.kernel_blocks['rmsnorm_decode']}; {len(calls)} flash "
          f"calls at the winner's tiles; launches {tl}; prefill "
          f"{tres.prefill_seconds:.4f} s, decode "
          f"{tres.decode_tokens_per_sec:.2f} tok/s")
    print("    against (b): " + divergence_report(
        model, params, wave, wres.tokens, tres.tokens, bar, "tuned wave"))
    print(f"  phase 13: {time.perf_counter() - t_phase:.2f} s")
    return wl["flash_attention"]


def wave_logit_error(model, params, prompt, generated):
    """Phase 5's logit error on a dense-cache stack: the last logits of
    ``prompt + generated[:-1]`` through whole-prompt prefill then one
    decode step a token, against one prefill of the whole sequence.
    Returns their largest absolute difference."""
    tokens = torch.tensor([list(prompt)], device=model.device)
    cache = model.init_cache(1, len(prompt) + len(generated))
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    for tok in generated[:-1]:
        logits, cache = model.decode_step(
            params, torch.tensor([[tok]], device=model.device), cache)
    a = logits[0, -1, :model.cfg.vocab_size].float()
    b = dense_prefill_logits(model, params,
                             list(prompt) + list(generated[:-1]))
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          "zamba2 serve: logits not finite")
    return float((a - b).abs().max())


def phase_zamba_serve(model, params, card):
    """Phase 14 on phase 8's model (attn_impl="pallas"): 8 prompts of 512
    tokens on ServeConfig(max_seq=1024, batch_slots=4, kv_layout="paged"),
    which the reference's wave fallback serves in 2 waves over dense
    caches.  Returns the flash launches."""
    cfg = model.cfg
    t_phase = time.perf_counter()
    scfg = ServeConfig(max_seq=1024, batch_slots=4, kv_layout="paged")
    rng = np.random.default_rng(SEED + 14)
    prompts = rng.integers(1, cfg.vocab_size, size=(8, WAVE_PROMPT)).tolist()
    n_shared = sum(k == "shared" for k in cfg.superblock) * cfg.n_superblocks
    engine = ServeEngine(model, params, scfg, device=DEV)
    check(not engine._continuous and engine.last_alloc is None,
          "zamba2 serve: not on the wave runtime")
    check(engine.cfg.kv_cache_pages * 16 >= scfg.batch_slots * scfg.max_seq,
          f"zamba2 serve: kv_cache_pages {engine.cfg.kv_cache_pages} under "
          f"the dense footprint")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kept, shapes, undo = capture_flash()
    try:
        reset_counts()
        res = engine.generate(prompts, WAVE_NEW)
        launched = counts()
    finally:
        undo()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    waves = len(prompts) // scfg.batch_slots
    check(launched["flash_attention"] == n_shared * waves
          and set(shapes) == {(4, WAVE_PROMPT, cfg.n_heads, cfg.head_dim_)},
          f"zamba2 serve: {launched['flash_attention']} flash launches at "
          f"{set(shapes)} (expected {n_shared} a wave at H={cfg.n_heads}, "
          f"D={cfg.head_dim_})")
    check(res.prefill_chunks == waves, f"zamba2 serve: {res.prefill_chunks}"
                                       f" prefill dispatches, {waves} waves")
    check(launched["paged_flash_decode"] == 0 and launched["gla"] == 0,
          f"zamba2 serve: launches {launched}")
    for toks in res.tokens:
        check(len(toks) == WAVE_NEW and all(0 <= t < cfg.vocab_size
                                            for t in toks),
              "zamba2 serve: a malformed continuation")
    check_captured_flash(kept, "zamba2 serve")
    logit_err = wave_logit_error(model, params, prompts[0], res.tokens[0])
    bar = DIVERGE_GAP_FACTOR * logit_err
    blocked = Model(replace(cfg, attn_impl="blocked"), device=DEV)
    bres = ServeEngine(blocked, params, scfg, device=DEV).generate(
        prompts, WAVE_NEW)
    print(f"  {card}; zamba2-1.2b bf16 full width, ServeConfig(max_seq="
          f"{scfg.max_seq}, batch_slots={scfg.batch_slots}, "
          f"kv_layout={scfg.kv_layout!r})")
    print(f"  serve: 2 waves of 4 x {WAVE_PROMPT} tokens: prefill "
          f"{res.prefill_seconds:.4f} s, decode {res.decode_seconds:.4f} s, "
          f"{res.decode_tokens_per_sec:.2f} tok/s, {res.steps} steps, "
          f"{res.prefill_chunks} prefill dispatches, launches {launched}, "
          f"peak {peak_gb:.2f} GB, kv_cache_pages "
          f"{engine.cfg.kv_cache_pages}; decode-path vs prefill-path max "
          f"abs logit difference {logit_err:.6f}")
    print(f"  attn_impl=blocked: prefill {bres.prefill_seconds:.4f} s; "
          "against it: " + divergence_report(
              blocked, params, prompts, bres.tokens, res.tokens, bar,
              "zamba2 serve", dense_prefill_logits))
    cache = model.init_cache(4, scfg.max_seq)
    cache["index"] = WAVE_PROMPT + WAVE_NEW // 2
    feed = torch.ones((4, 1), dtype=torch.long, device=DEV)

    def decode():
        cache["index"] = WAVE_PROMPT + WAVE_NEW // 2
        logits, _ = model.decode_step(params, feed, cache)
        return logits.float().argmax(-1).cpu()

    profile_step(decode, f"zamba2 wave decode step (B=4 at length "
                         f"{cache['index']}: 36 Mamba2 steps, 2 dense "
                         "attentions)", annotate=("_dense_attend",))
    del cache

    # f32 at one superblock's depth: the card against the CPU
    f32 = replace(cfg, n_layers=len(cfg.superblock), param_dtype="float32",
                  compute_dtype="float32")
    p_dev = Model(f32, device=DEV).init(SEED)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    small = [p[:128] for p in prompts[:4]]
    out = {}
    for dev, p in (("cpu", p_cpu), (DEV, p_dev)):
        m = Model(f32, device=dev)
        out[dev] = (m, p, ServeEngine(m, p, ServeConfig(
            max_seq=256, batch_slots=4), device=dev).generate(small, 8))
    m_cpu, _, want = out["cpu"]
    got = out[DEV][2]
    err32 = wave_logit_error(m_cpu, p_cpu, small[0], want.tokens[0])
    bar32 = DIVERGE_GAP_FACTOR * max(err32, 1e-6)
    check((got.steps, got.prefill_chunks) == (want.steps,
                                              want.prefill_chunks),
          f"zamba2 f32: counts {got.steps}/{got.prefill_chunks} vs "
          f"{want.steps}/{want.prefill_chunks}")
    print(f"  f32, one superblock ({f32.n_layers} layers), 4 x 128 tokens, "
          f"8 new: card against the CPU: " + divergence_report(
              m_cpu, p_cpu, small, want.tokens, got.tokens, bar32,
              "zamba2 f32", dense_prefill_logits))
    print(f"  phase 14: {time.perf_counter() - t_phase:.2f} s")
    return launched["flash_attention"]


# ---------------------------------------------------------------------------
# phase 8: Zamba2-1.2B's forward and LM loss at full width
# ---------------------------------------------------------------------------
def profile_forward(fn):
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler``: (device busy ms, {kernel name: ms})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + dt / 1e3
    return sum(kernels.values()), kernels


def loss_and_hidden(m, params, batch):
    """``m.loss(params, batch, loss_chunk=1024)`` and the hidden state that
    its own ``forward`` computed, so one pass gives both."""
    seen = []
    forward = m.forward
    m.forward = lambda *a, **kw: seen.append(forward(*a, **kw)) or seen[-1]
    try:
        total, metrics = m.loss(params, batch, loss_chunk=1024)
    finally:
        del m.forward
    return total, metrics, seen[0][0]


def phase_zamba():
    base = get_config("zamba2-1.2b")
    cfg = replace(base, gla_impl="pallas", attn_impl="pallas")
    B, S = 1, SHAPES["train_4k"].seq_len  # train_4k's length; batch cut
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(cfg, device=DEV)
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in _leaves(params))
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S))
                              ).to(DEV)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    n_mamba = sum(k == "mamba2" for k in cfg.superblock) * cfg.n_superblocks
    n_shared = sum(k == "shared" for k in cfg.superblock) * cfg.n_superblocks

    def run_loss(m):
        return m.loss(params, batch, loss_chunk=1024)

    with torch.no_grad():
        run_loss(model)  # warm-up: cuBLAS handles, the allocator's pools
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        total, metrics, hidden = loss_and_hidden(model, params, batch)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t) * 1e3
        launched = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launched["gla"] == n_mamba,
              f"{launched['gla']} GLA launches in one forward, expected "
              f"{n_mamba} (one a Mamba2 layer)")
        check(launched["flash_attention"] == n_shared,
              f"{launched['flash_attention']} flash-attention launches in "
              f"one forward, expected {n_shared} (one a shared block)")
        check(all(n == 0 for name, n in launched.items()
                  if name not in ("gla", "flash_attention")),
              f"unexpected launches on the forward path: {launched}")
        busy_ms, kernels = profile_forward(lambda: run_loss(model))

        # one call: the plain path launches no kernel of its own to warm up
        plain = Model(replace(base, gla_impl="jnp", attn_impl="blocked"),
                      device=DEV)
        t = time.perf_counter()
        p_total, p_metrics, p_hidden = loss_and_hidden(plain, params, batch)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3

    loss, p_loss = float(metrics["loss"]), float(p_metrics["loss"])
    check(hidden.shape == (B, S, cfg.d_model)
          and hidden.dtype == torch.bfloat16,
          f"hidden {tuple(hidden.shape)} {hidden.dtype}")
    check(bool(torch.isfinite(hidden.float()).all()) and np.isfinite(loss),
          "zamba2 forward not finite")
    check(abs(loss - p_loss) <= ZAMBA_LOSS_TOL,
          f"loss {loss:.6f} on the kernels vs {p_loss:.6f} on the plain "
          f"versions (tol {ZAMBA_LOSS_TOL})")
    rel = float((hidden.float() - p_hidden.float()).norm()
                / p_hidden.float().norm())
    check(rel <= ZAMBA_HIDDEN_REL_TOL,
          f"hidden state relative error {rel:.3e} > {ZAMBA_HIDDEN_REL_TOL}")
    n_tok = float(metrics["tokens"])
    check(n_tok == float(p_metrics["tokens"]) == B * S,
          f"tokens {n_tok} vs {float(p_metrics['tokens'])}")
    flips = abs(float(metrics["accuracy"]) - float(p_metrics["accuracy"])
                ) * n_tok
    check(flips <= ZAMBA_ACC_FLIPS, f"accuracy differs by {flips:.0f} tokens")
    # f32 at one superblock's depth (19 layers), kernels against plain
    f32 = dict(n_layers=len(cfg.superblock), param_dtype="float32",
               compute_dtype="float32")
    k32 = Model(replace(cfg, **f32), device=DEV)
    p32 = k32.init(SEED)
    p32_model = Model(replace(base, gla_impl="jnp", attn_impl="blocked",
                              **f32), device=DEV)
    with torch.no_grad():
        reset_counts()
        _, m32, h32 = loss_and_hidden(k32, p32, batch)
        n32 = counts()
        _, pm32, ph32 = loss_and_hidden(p32_model, p32, batch)
    l32, pl32 = m32["loss"], pm32["loss"]
    rel32 = float((h32 - ph32).norm() / ph32.norm())
    check(n32["gla"] == n_mamba // cfg.n_superblocks
          and n32["flash_attention"] == n_shared // cfg.n_superblocks,
          f"f32 superblock launches {n32}")
    check(rel32 <= ZAMBA_F32_REL_TOL,
          f"f32 superblock: hidden state relative error {rel32:.3e} > "
          f"{ZAMBA_F32_REL_TOL}")
    del k32, p32, p32_model, h32, ph32
    gla_parts = {part: sum(ms for k, ms in kernels.items()
                           if f"gla_{part}_kernel" in k)
                 for part in ("state", "scan", "out")}
    gla_ms = sum(gla_parts.values())
    flash_ms = sum(ms for k, ms in kernels.items()
                   if "flash_tc_kernel" in k or "flash_attention_kernel" in k)
    print(f"  zamba2-1.2b bf16 full width: {n_params} params (init "
          f"{init_s:.2f} s), B={B} S={S}, {cfg.n_layers} layers: {n_mamba} "
          f"mamba2, {n_shared} shared-block invocations")
    print(f"  Model.loss (loss_chunk 1024, no grad): {fwd_ms:.4f} ms, peak "
          f"{peak_gb:.2f} GB, launches {launched}; loss {loss:.6f}, accuracy "
          f"{float(metrics['accuracy']):.6f}, tokens {n_tok:.0f}")
    print(f"  plain versions (gla_impl=jnp, attn_impl=blocked): "
          f"{plain_ms:.4f} ms (one call), loss {p_loss:.6f} (|diff| "
          f"{abs(loss - p_loss):.3e}, tol {ZAMBA_LOSS_TOL}), accuracy "
          f"{float(p_metrics['accuracy']):.6f}; hidden state relative error "
          f"{rel:.3e} (tol {ZAMBA_HIDDEN_REL_TOL})")
    print(f"  f32, one superblock ({len(cfg.superblock)} layers): hidden "
          f"state relative error {rel32:.3e} (tol {ZAMBA_F32_REL_TOL}), loss "
          f"{float(l32):.6f} vs {float(pl32):.6f} plain, launches {n32}")
    if kernels:
        print(f"  profiled forward: device busy {busy_ms:.4f} ms, idle share "
              f"{max(0.0, 1 - busy_ms / fwd_ms):.3f} of the unprofiled "
              f"{fwd_ms:.4f} ms; GLA kernel {gla_ms:.4f} ms "
              f"({gla_ms / n_mamba:.4f} a launch: chunk states "
              f"{gla_parts['state'] / n_mamba:.4f}, scan "
              f"{gla_parts['scan'] / n_mamba:.4f}, outputs "
              f"{gla_parts['out'] / n_mamba:.4f}), flash kernel "
              f"{flash_ms:.4f} ms; top kernels (ms):")
        for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:.4f}  {key[:100]}")
    else:
        print("  device time per kernel: not measured (the profiler saw no "
              "device events)")
    return launched, model, params


# ---------------------------------------------------------------------------
# phase 10: ACTS co-tunes the serve engine, the train step and the decode
# kernel as one system (launch.tune --joint, --joint --real)
# ---------------------------------------------------------------------------
# Gemma-7B's width with the depth cut from 28 layers to COTUNE_LAYERS:
# the train member's fresh model, gradients and f32 moments must fit one
# card beside the serve member's model
COTUNE_LAYERS = 4
COTUNE_BUDGET = 8
COTUNE_RETIMES = 5


def cotune_surrogate(tmp):
    """(a) ``launch.tune --joint`` on the analytic surrogate: its winners
    read back under the cost model's key, and nothing ran on the card."""
    from repro_torch.launch.tune import main as tune_main

    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    t = time.perf_counter()
    rc = tune_main(["--arch", "gemma-7b", "--shape", "train_4k", "--joint",
                    "--surrogate", "--budget", "24", "--out-dir", tmp])
    seconds = time.perf_counter() - t
    check(rc == 0, f"launch.tune --joint exited {rc}")
    check(all(n == 0 for n in counts().values()),
          f"the surrogate run launched kernels: {counts()}")
    check(torch.cuda.memory_allocated() == mem0,
          "the surrogate run allocated memory on the card")
    report = json.load(open(os.path.join(
        tmp, "joint_gemma-7b_train_4k.json")))
    best = report["best"]["config"]
    serve = {k.split(".", 1)[1]: v for k, v in best.items()
             if k.startswith("serve.")}
    kernel = {k.split(".", 1)[1]: v for k, v in best.items()
              if k.startswith("kernel.")}
    keys = report["persisted"]
    check(keys["backend"] == "model-sm90",
          f"the surrogate's winners went under {keys['backend']}")
    got_serve = autotune.cached_serve_config(keys["serve"], keys["dtype"],
                                             backend="model-sm90")
    got_kernel = autotune.cached_blocks("decode_attention", keys["kernel"],
                                        keys["dtype"], backend="model-sm90")
    check(got_serve == serve and got_kernel == kernel,
          f"the surrogate's winners did not read back under model-sm90: "
          f"{got_serve} / {got_kernel} against {serve} / {kernel}")
    won = report["best"]["metrics"]
    print(f"  (a) --joint surrogate, budget 24: {report['n_tests']} tests, "
          f"{seconds:.2f} s, default {report['default']['value']:.1f} -> "
          f"best {report['best']['value']:.1f} tok/s (model; its decode "
          f"step {won['step_s']:.6f} s, attention {won['attn_s']:.6f} s); "
          f"serve {serve}, kernel {kernel}; no launch, no card memory")


def cotune_live(card):
    """(b) the live composite at Gemma-7B's width, depth cut: every trial
    rebuilds and times the real engine and train step on the card and
    times the dense decode kernel."""
    from repro_torch.launch.tune import persist_joint_winners
    from repro_torch.core.tuner import Tuner
    from repro_torch.serve.space import (apply_serve_knobs,
                                         make_live_cotune_sut)

    full = get_config("gemma-7b")
    cfg = replace(full, n_layers=COTUNE_LAYERS)
    gib = 1e9
    for c in (full, cfg):
        n = count_params(c)
        print(f"  train member at {c.n_layers} layers: {n / 1e9:.3f} B "
              f"params: bf16 params {2 * n / gib:.1f} GB + bf16 grads "
              f"{2 * n / gib:.1f} GB + f32 moments {8 * n / gib:.1f} GB = "
              f"{12 * n / gib:.1f} GB before activations and the update's "
              f"f32 temporaries")
    serve_gb = 2 * count_params(cfg) / gib
    print(f"  serve member's model: {serve_gb:.1f} GB bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    sut = make_live_cotune_sut(cfg, max_seq=128, prompt_len=32, gen_len=8,
                               n_requests=8, max_slots=8, train_seq=32,
                               train_batch=8, repeats=3, seed=SEED,
                               device=DEV)
    serve, train, kernel = (sut.members[n]
                            for n in ("serve", "train", "kernel"))
    seen = {"serve": [], "train": [], "kernel": 0, "trials": []}

    def serve_test(config, test=serve.test):
        before = pa.paged_flash_decode_cuda.launches
        m = test(config)
        seen["serve"].append((config, m,
                              pa.paged_flash_decode_cuda.launches - before))
        return m

    def train_test(config, test=train.test):
        m = test(config)
        seen["train"].append((config, m))
        return m

    def kernel_batch(configs, batch=kernel.test_batch):
        before = fd.flash_decode_cuda.launches
        out = batch(configs)
        seen["kernel"] += fd.flash_decode_cuda.launches - before
        return out

    def composite_batch(configs, batch=sut.test_batch):
        out = batch(configs)
        for config, m in zip(configs, out):
            seen["trials"].append((config, m))
            print(f"    ({time.perf_counter() - t0:.1f} s) trial "
                  f"{len(seen['trials'])}: value {m.value:.2f}, peak so far "
                  f"{torch.cuda.max_memory_allocated() / gib:.2f} GB",
                  flush=True)
        return out

    serve.test, train.test = serve_test, train_test
    kernel.test_batch, sut.test_batch = kernel_batch, composite_batch
    space = sut.space()
    rep = Tuner(space, sut, budget=COTUNE_BUDGET, optimizer="subspace_rr",
                seed=0).run()
    parts = space.split(rep.best_config)
    backend = autotune.backend_name(DEV)
    keys = persist_joint_winners(rep, sut, backend=backend,
                                 mode="joint-real")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / gib

    check(rep.n_tests == COTUNE_BUDGET,
          f"{rep.n_tests} tests of a budget of {COTUNE_BUDGET}")
    check(len(seen["serve"]) == len(seen["train"]) == len(seen["trials"])
          == rep.n_tests,
          f"{len(seen['serve'])} serve, {len(seen['train'])} train tests "
          f"and {len(seen['trials'])} trials for {rep.n_tests} tests")
    runs = serve.warmup + serve.repeats
    for config, m, n in seen["serve"]:
        single = 0 if int(config["draft_len"]) else m.metrics["steps"]
        check(n == cfg.n_layers * single * runs,
              f"serve trial {config}: {n} paged launches, expected "
              f"{cfg.n_layers} x {single} steps x {runs} runs")
        check(m.metrics["tokens"] == 8 * 8,
              f"serve trial generated {m.metrics['tokens']} tokens")
    check(seen["kernel"] > 0 and launched["flash_decode"] > 0,
          "the kernel member never launched the dense decode kernel")
    # every block_kv the tuner tried, on the kernel member's own inputs,
    # against the plain version (after the counts were read)
    q, k, v, kv_len = kernel._get_inputs()
    want = fd.decode_attention_ref(q, k, v, kv_len)
    tried = sorted({space.split(c)["kernel"]["block_kv"]
                    for c, _ in seen["trials"]})
    kernel_errs = {bkv: close(kernel.kspace.definition.call(
        (q, k, v, kv_len), {"block_kv": bkv}), want,
        f"kernel member block_kv {bkv}") for bkv in tried}
    del q, k, v, kv_len, want
    for config, m in seen["train"]:
        check(np.isfinite(m.metrics["loss"]),
              f"train trial {config}: loss {m.metrics['loss']}")
    reads = {
        "kernel": autotune.cached_blocks("decode_attention", keys["kernel"],
                                         keys["dtype"], backend=backend),
        "serve": autotune.cached_serve_config(keys["serve"], keys["dtype"],
                                              backend=backend),
        "train": autotune.cached_train_config(keys["train"], keys["dtype"],
                                              backend=backend)}
    check(reads == parts, f"winners under {backend}: {reads}, tuned {parts}")
    engine = ServeEngine(serve.model, serve.params,
                         apply_serve_knobs(parts["serve"], serve.base),
                         device=DEV)
    res = engine.generate(serve.prompts, serve.gen_len)
    check([len(t) for t in res.tokens] == [serve.gen_len] * 8,
          "the winning serve config did not generate every token")
    engine.last_alloc.check_balanced()

    print(f"  {card}; (b) live, gemma-7b width at {COTUNE_LAYERS} layers: "
          f"{rep.n_tests} tests in {wall:.2f} s (make_live_cotune_sut + "
          f"tuner + persist), peak {peak_gb:.2f} GB, kernel_ref "
          f"{sut.scalarize.kernel_ref * 1e3:.4f} ms, launches {launched}; "
          f"the kernel member's output at each block_kv tried, max abs err "
          + ", ".join(f"{b}: {e:.3e}" for b, e in kernel_errs.items())
          + f" (tol {TOL[torch.bfloat16]})")
    for i, (config, m) in enumerate(seen["trials"]):
        mv = m.metrics["member_values"]
        sub = space.split(config)
        print(f"    trial {i + 1}: value {m.value:.2f} (serve "
              f"{mv['serve']:.2f} tok/s, latency {m.metrics['latency_s']:.4f}"
              f" s; train {mv['train']:.2f} tok/s; kernel "
              f"{mv['kernel'] * 1e3:.4f} ms) serve {sub['serve']} train "
              f"{sub['train']} kernel {sub['kernel']}")
    print(f"    winner: serve {parts['serve']}, train {parts['train']}, "
          f"kernel {parts['kernel']}; deployed: {res.steps} steps, "
          f"{res.decode_tokens_per_sec:.2f} decode tok/s")
    # default against winner, re-timed in turns (records, not checks: the
    # host's pace moves serve tok/s by 2x between calls)
    default = space.default_config()
    times = {"default": [], "winner": []}
    for _ in range(COTUNE_RETIMES):
        for name, config in (("default", default),
                             ("winner", rep.best_config)):
            times[name].append(sut.test(config).value)
    print("    re-timed in turns, value (default / winner): "
          + "; ".join(f"{a:.2f} / {b:.2f}" for a, b in
                      zip(times["default"], times["winner"]))
          + f"; medians {statistics.median(times['default']):.2f} / "
          f"{statistics.median(times['winner']):.2f}")
    return launched


def cotune_launcher(tmp):
    """(c) ``launch.tune --joint --real`` through the launcher, at the
    reference's reduced config, on the card."""
    from repro_torch.launch.tune import main as tune_main

    t = time.perf_counter()
    rc = tune_main(["--arch", "gemma-7b", "--shape", "train_4k", "--joint",
                    "--real", "--budget", "8", "--real-repeats", "1",
                    "--out-dir", tmp])
    seconds = time.perf_counter() - t
    check(rc == 0, f"launch.tune --joint --real exited {rc}")
    keys = json.load(open(os.path.join(
        tmp, "joint_gemma-7b_train_4k_real.json")))["persisted"]
    backend = autotune.backend_name(DEV)
    check(keys["backend"] == backend,
          f"the launcher's winners went under {keys['backend']}")
    reads = [autotune.cached_blocks("decode_attention", keys["kernel"],
                                    keys["dtype"], backend=backend),
             autotune.cached_serve_config(keys["serve"], keys["dtype"],
                                          backend=backend),
             autotune.cached_train_config(keys["train"], keys["dtype"],
                                          backend=backend)]
    check(all(r is not None for r in reads),
          f"launch.tune --joint --real wrote {reads} under {backend}")
    print(f"  (c) launch.tune --joint --real (reduced gemma-7b, budget 8, "
          f"1 repeat): {seconds:.2f} s; kernel {reads[0]}, serve "
          f"{reads[1]}, train {reads[2]}")


def phase_cotune(card):
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cotune_") as tmp:
        cotune_surrogate(tmp)
        launched = cotune_live(card)
        cotune_launcher(tmp)
    print(f"  phase 10: {time.perf_counter() - t:.2f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 12: the fault-tolerant train loop with checkpoints
# ---------------------------------------------------------------------------
# Gemma-7B's width with the depth cut from 28 layers to TRAIN_LAYERS: at
# 28 the bf16 params, f32 moments and the step's f32 gradients need about
# 102.5 GB, more than the card's 80; at 2 the model has 1.34 B params
TRAIN_LAYERS = 2
TRAIN_STEPS = 6
TRAIN_FAIL_AT = 3
# the train step's parity bars (tests/test_torch_train.py): losses to
# LOSS_TOL; the final params' distance from the uninterrupted run's, over
# the uninterrupted run's update, to UPDATE_TOL; at most OFF_SHARE of the
# elements more than lr/10 apart
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_UPDATE_TOL = 2e-2
TRAIN_OFF_SHARE = 1e-3
TRAIN_LR = 1e-3
MEASURED_BUDGET = 4


def leaf_crcs(tree) -> dict:
    """{leaf name, as the checkpoint names it: CRC32 of the whole leaf's
    bytes}, each leaf's bytes read from where it lies."""
    import zlib

    from repro_torch.checkpoint.manager import _flatten_with_names

    return {name: zlib.crc32(leaf.detach().contiguous().reshape(-1)
                             .view(torch.uint8).cpu().numpy())
            for name, leaf in _flatten_with_names(tree)}


def flat32(params) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1)
                      for p in _leaves(params)])


def phase_train_loop(card):
    """``train()`` at Gemma-7B's width (depth cut to TRAIN_LAYERS): a run
    with async checkpoints every 2 steps is killed at step TRAIN_FAIL_AT,
    resumes from its newest checkpoint (step 2) and finishes; it is held
    to an uninterrupted run that writes no checkpoint.  Every restored
    leaf's CRC32 must equal the CRC32 taken of that leaf when it was
    saved, before the next step ran.  Then TorchMeasuredSUT on the same
    model (8 x 128 tokens a step) under the tuner on the card."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.sut_torch import TorchMeasuredSUT
    from repro_torch.core.tuner import Tuner
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import (SimulatedFailure, TrainLoopConfig,
                                   loop as loop_mod, train)

    t_phase = time.perf_counter()
    cfg = replace(get_config("gemma-7b"), n_layers=TRAIN_LAYERS)
    n = count_params(cfg)
    emb = cfg.padded_vocab * cfg.d_model
    print(f"  {card}; gemma-7b width at {TRAIN_LAYERS} of 28 layers: {n} "
          f"params (embedding {emb}, {(n - emb - cfg.d_model) // 2} a "
          f"layer): bf16 params {2 * n / 1e9:.2f} GB + f32 moments "
          f"{8 * n / 1e9:.2f} GB = a {10 * n / 1e9:.2f} GB checkpoint")

    def loop(**kw):
        return TrainLoopConfig(
            steps=TRAIN_STEPS, seq_len=128, global_batch=8, log_every=0,
            opt=OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                                schedule="constant"), **kw)

    seen = {"saves": [], "writes": [], "restores": []}

    class Recording(CheckpointManager):
        """The loop's manager, recording each save's leaf CRCs (taken
        before ``save`` returns, so before the next step runs), each
        save's and restore's seconds, and each restored tree's CRCs."""

        def save(self, step, tree, extra=None):
            crcs = leaf_crcs(tree)
            t = time.perf_counter()
            super().save(step, tree, extra)
            seen["saves"].append((step, crcs, time.perf_counter() - t))

        def _save_sync(self, step, leaves, extra):
            t = time.perf_counter()
            super()._save_sync(step, leaves, extra)
            seen["writes"].append((step, time.perf_counter() - t))

        def restore(self, template, step=None, shardings=None):
            t = time.perf_counter()
            got, tree = super().restore(template, step, shardings)
            seen["restores"].append((got, leaf_crcs(tree),
                                     time.perf_counter() - t))
            return got, tree

    reset_counts()
    straight = train(cfg, loop(), device=DEV)
    want_losses = [h["loss"] for h in straight["history"]]
    want = flat32(straight["params"])
    step_s = [h["step_seconds"] for h in straight["history"]]
    del straight
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="train_loop_") as ckpt:
        kw = dict(ckpt_dir=ckpt, ckpt_every=2, ckpt_keep=1, ckpt_async=True)
        loop_mod.CheckpointManager = Recording
        try:
            failed = False
            try:
                train(cfg, loop(fail_at_step=TRAIN_FAIL_AT, **kw),
                      device=DEV)
            except SimulatedFailure:
                failed = True
            check(failed, "train: no SimulatedFailure")
            torch.cuda.empty_cache()
            resumed = train(cfg, loop(**kw), device=DEV)
        finally:
            loop_mod.CheckpointManager = CheckpointManager
        launches = counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        left = sorted(os.listdir(ckpt))
        ckpt_bytes = sum(
            os.path.getsize(os.path.join(ckpt, left[-1], f))
            for f in os.listdir(os.path.join(ckpt, left[-1])))
    check(left == [f"step_{TRAIN_STEPS:010d}"],
          f"train: {left} left (keep 1, no .tmp)")
    check(len(seen["restores"]) == 1 and seen["restores"][0][0] == 2,
          f"train: restores {[r[0] for r in seen['restores']]}")
    saved = {step: crcs for step, crcs, _ in seen["saves"]}
    restored_crcs = seen["restores"][0][1]
    bad = [k for k, v in restored_crcs.items() if saved[2].get(k) != v]
    check(not bad and len(restored_crcs) == len(saved[2]),
          f"train: {len(bad)} restored leaves differ from the step-2 save "
          f"(e.g. {bad[:3]})")
    got_losses = [h["loss"] for h in resumed["history"]]
    check(len(got_losses) == TRAIN_STEPS - 2,
          f"train: resumed ran {len(got_losses)} steps")
    check(np.allclose(got_losses, want_losses[2:], **TRAIN_LOSS_TOL),
          f"train: resumed losses {got_losses} vs uninterrupted "
          f"{want_losses[2:]} ({TRAIN_LOSS_TOL})")
    got = flat32(resumed["params"])
    del resumed
    torch.cuda.empty_cache()
    p0 = flat32(Model(cfg, device=DEV).init(SEED))
    update_err = float((got - want).norm() / (want - p0).norm())
    off = float(((got - want).abs() > TRAIN_LR / 10).double().mean())
    del got, want, p0
    check(update_err <= TRAIN_UPDATE_TOL and off <= TRAIN_OFF_SHARE,
          f"train: resumed params {update_err:.3e} of the update apart "
          f"(bar {TRAIN_UPDATE_TOL}), {off:.3e} of elements apart (bar "
          f"{TRAIN_OFF_SHARE})")
    check(all(math.isfinite(x) for x in got_losses + want_losses),
          "train: a loss is not finite")
    print(f"  uninterrupted: losses {[round(x, 6) for x in want_losses]}; "
          f"step seconds {[round(x, 4) for x in step_s]}")
    print(f"  killed at step {TRAIN_FAIL_AT}, resumed from step 2: losses "
          f"{[round(x, 6) for x in got_losses]}; final params "
          f"{update_err:.3e} of the update apart, {off:.3e} of elements "
          f"more than lr/10 apart; {len(restored_crcs)} restored leaves' "
          f"CRC32 equal the step-2 save's; peak {peak_gb:.2f} GB; kernel "
          f"launches {launches}")
    print(f"  checkpoint {ckpt_bytes} bytes; save (host copy, blocking) "
          + ", ".join(f"step {st}: {sec:.3f} s" for st, _, sec in
                      seen["saves"])
          + "; write (background) " + ", ".join(
              f"step {st}: {sec:.3f} s" for st, sec in seen["writes"])
          + f"; restore {seen['restores'][0][2]:.3f} s")

    sut_seen = []

    class RecordingSUT(TorchMeasuredSUT):
        def test(self, config):
            m = super().test(config)
            sut_seen.append((config, m))
            return m

    torch.cuda.empty_cache()
    sut = RecordingSUT(cfg, seq_len=128, global_batch=8, device=DEV)
    report = Tuner(sut.space(), sut, budget=MEASURED_BUDGET,
                   seed=SEED).run()
    check(len(sut_seen) == MEASURED_BUDGET,
          f"measured SUT: {len(sut_seen)} tests")
    for config, m in sut_seen:
        check(math.isfinite(m.value) and m.value > 0
              and math.isfinite(m.metrics["loss"]),
              f"measured SUT: {config} gave {m}")
        print(f"  TorchMeasuredSUT {config}: {m.value:.2f} tok/s, "
              f"{m.metrics['step_seconds'] * 1e3:.4f} ms a step, loss "
              f"{m.metrics['loss']:.6f}")
    print(f"  best {report.best_config} at {report.best_metric.value:.2f} "
          f"tok/s; phase 12: {time.perf_counter() - t_phase:.2f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    def phase(n, what):
        print(f"[{n}/14] ({time.perf_counter() - t_start:.1f} s) {what}")

    print(f"[1/14] device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "cache.json")
        autotune.reset_default_cache()
        try:
            built = build.build_all(force=True)
            phase(2, "build (one nvcc a source, all at once):")
            for src, b in built.items():
                regs = [int(w) for line in b.log.splitlines()
                        if "registers" in line
                        for w, nxt in zip(line.split(), line.split()[1:])
                        if nxt.startswith("registers")]
                spills = [line.strip() for line in b.log.splitlines()
                          if "spill" in line and not line.strip().startswith(
                              "0 bytes stack frame, 0 bytes spill stores")]
                print(f"  {src}.cu: {b.seconds:.2f} s, {len(regs)} kernels, "
                      f"max {max(regs, default=0)} registers/thread, "
                      f"{len(spills)} with spills or stack")
                for line in spills:
                    print(f"    {line}")
            # the bf16 tensor-core flash kernel: registers and spills of
            # each (D, key tile) instantiation
            tc = [(k, r, st, ld) for k, r, st, ld in
                  ptxas_kernels(built["flash_attention"].log)
                  if "flash_tc_kernel" in k]
            check(len(tc) == len(fa.HEAD_DIMS) * len(fa.TILE_KEYS) - 1,
                  f"{len(tc)} bf16 flash instantiations in the ptxas report")
            print("  flash_attention.cu bf16 (D, key tile): registers, "
                  "spill store/load bytes: " + "; ".join(
                      "({}, {}): {}, {}/{}".format(*re.search(
                          r"flash_tc_kernelILi(\d+)ELi(\d+)E", k).groups(),
                          r, st, ld) for k, r, st, ld in tc))
            spilled = [k for k, _, st, ld in tc if st or ld]
            check(not spilled, f"bf16 flash instantiations spill: {spilled}")
            phase(3, "kernels against their plain versions")
            records = phase_kernels()
            phase(4, "port on the card against the port on the cpu")
            phase_parity()
            phase(5, "gemma-7b at full width (slice 1's main path)")
            (model, params, prompts, max_new, res, launches,
             logit_err) = phase_serve()
            records["paged_flash_decode"]["launches"] = launches
            phase(6, "launch.tune --tune-kernels at gemma-7b width "
                  "(slice 2's main path)")
            tuned = phase_tune()
            for name_ in ("flash_attention", "flash_decode", "rmsnorm"):
                records[name_]["launches"] = tuned[name_]
            phase(7, "gemma-7b served with autotune_kernels on that "
                  "cache")
            phase_autotune_serve(model, params, prompts, max_new, res)
            phase(9, "the serve knobs on gemma-7b at full width (slice "
                  "7's main path; before phase 8, on phase 5's model)")
            phase_knobs(model, params, prompts, max_new, res, logit_err,
                        card)
            phase(11, "online retuning on gemma-7b at full width (slice "
                  "9's main path; after phase 9, before phase 8)")
            retuned = phase_retune(model, params, logit_err, card)
            records["paged_flash_decode"]["retune_launches"] = retuned[
                "paged_flash_decode"]
            phase(13, "the dense layout and the wave runtime on gemma-7b "
                  "at full width (slice 10's main path; after phase 11, "
                  "before phase 8)")
            serve = {"gemma_wave": phase_dense_wave(
                model, params, prompts, max_new, res, logit_err, card)}
            del model, params
            torch.cuda.empty_cache()
            phase(8, "zamba2-1.2b forward and loss at full width "
                  "(slice 3's main path)")
            launched, model, params = phase_zamba()
            records["gla"]["launches"] = launched["gla"]
            phase(14, "zamba2-1.2b served on the wave runtime at full "
                  "width (slice 10; after phase 8, on its model)")
            serve["zamba2_wave"] = phase_zamba_serve(model, params, card)
            records["flash_attention"]["serve_launches"] = serve
            del model, params
            torch.cuda.empty_cache()
            phase(10, "ACTS co-tunes serve engine, train step and decode "
                  "kernel (launch.tune --joint, --joint --real; slice 8's "
                  "main path)")
            cotuned = phase_cotune(card)
            for name_ in ("paged_flash_decode", "flash_decode"):
                records[name_]["cotune_launches"] = cotuned[name_]
            torch.cuda.empty_cache()
            phase(12, "the fault-tolerant train loop with async "
                  "checkpoints at gemma-7b width (slice 9; last)")
            phase_train_loop(card)
        except PhaseError as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
