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
              at B=8 over 128 entries under every block_kv of its space.
4. parity   - a tiny f32 model served on the card and on the CPU from the
              same weights, under each serve knob (fifo, sjf, interleave,
              on_demand on a pool that preempts, share_prefix with a
              copy-on-write split, draft_len=3, temperature=0.8): tokens
              and the counts of steps, prefill chunks, preemptions, CoW
              splits, shared, drafted and accepted tokens must be equal;
              the paged kernel runs n_layers times a single-token step
              and never on a verify step.
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

Launch counts are set to 0 just before each main path (phases 5, 6, 7, 8,
each run of 9 and phase 10's live run) and read just after.  The autotune
cache of the whole run is a temporary file (REPRO_AUTOTUNE_CACHE); nothing
is written to the user's cache.  The line before the last is the card
line; the line before it the ``{"kernels": [...]}`` line; the last line
``{"ok": true, ...}``.
"""
from __future__ import annotations

import itertools
import json
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
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.gla import chunked_gla  # noqa: E402
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
            if shape in (gemma, ZAMBA_FLASH):
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
    ms, plain_ms, bound, lib_ms, dev_ms, lib_dev_ms = timed
    return record("flash_attention", errs[(gemma, torch.bfloat16)], ms,
                  plain_ms, bound, lib_ms, dev_ms, lib_dev_ms)


# B, S, SK, H, KV, D, causal, window, q_offset, block_q, block_kv
ZAMBA_FLASH = (1, 4096, 4096, 32, 32, 64, True, 0, 0, None, None)


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


def profile_decode_step(model, params, lengths, steps=5, columns=1):
    """Where one batched decode step's time goes, at the cell's shape:
    host wall time per step without the profiler, then device time per
    kernel under ``torch.profiler``; the idle share is the part of the
    unprofiled step during which no kernel ran.  ``columns`` > 1 profiles
    a verify step of that many tokens a slot."""
    from torch.profiler import ProfilerActivity, profile

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
    what = "decode step" if columns == 1 else f"verify step ({columns} " \
        "columns)"
    print(f"  {what} at lengths {lengths}: {wall_ms:.4f} ms wall "
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


def first_divergences(model, params, prompts, base, got):
    """Requests whose tokens equal the baseline's, and for each other one
    (request, position, the baseline's top-2 logit gap there): the gap
    from a prefill of prompt + the baseline's tokens before it."""
    same, diverged = 0, []
    for i, (a, b) in enumerate(zip(base, got)):
        if a == b:
            same += 1
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = torch.topk(prefill_logits(model, params,
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
    return launched


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


def gemma_param_count(cfg) -> int:
    """Parameters of a tied attn stack: embedding, per layer the
    attention projections, the gated MLP and two norms, the final norm."""
    d, hd = cfg.d_model, cfg.head_dim_
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    mlp = 3 * d * cfg.d_ff
    return cfg.padded_vocab * d + cfg.n_layers * (attn + mlp + 2 * d) + d


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
        n = gemma_param_count(c)
        print(f"  train member at {c.n_layers} layers: {n / 1e9:.3f} B "
              f"params: bf16 params {2 * n / gib:.1f} GB + bf16 grads "
              f"{2 * n / gib:.1f} GB + f32 moments {8 * n / gib:.1f} GB = "
              f"{12 * n / gib:.1f} GB before activations and the update's "
              f"f32 temporaries")
    serve_gb = 2 * gemma_param_count(cfg) / gib
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
        print(f"[{n}/10] ({time.perf_counter() - t_start:.1f} s) {what}")

    print(f"[1/10] device: {name}; torch {torch.__version__}, "
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
            del model, params
            torch.cuda.empty_cache()
            phase(8, "zamba2-1.2b forward and loss at full width "
                  "(slice 3's main path)")
            records["gla"]["launches"] = phase_zamba()["gla"]
            torch.cuda.empty_cache()
            phase(10, "ACTS co-tunes serve engine, train step and decode "
                  "kernel (launch.tune --joint, --joint --real; slice 8's "
                  "main path)")
            cotuned = phase_cotune(card)
            for name_ in ("paged_flash_decode", "flash_decode"):
                records[name_]["cotune_launches"] = cotuned[name_]
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
