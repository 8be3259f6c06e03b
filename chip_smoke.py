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
              inputs).
4. parity   - a tiny f32 model served on the card and on the CPU from the
              same weights: the greedy tokens must be equal.
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
8. zamba2   - Zamba2-1.2B at full width in bf16 (random weights from a
              seed), B=1, S=4096, under no-grad: ``Model.loss`` with
              gla_impl="pallas" and attn_impl="pallas" must launch the GLA
              kernel once per Mamba2 layer (36) and the flash-attention
              kernel once per shared-block invocation (2); its loss and
              hidden state are held to the same forward on the plain
              versions (gla_impl="jnp", attn_impl="blocked").  (Main path
              of port slice 3.)

Launch counts are set to 0 just before each main path (phases 5, 6, 7 and
8) and read just after.  The autotune cache of the whole run is a temporary
file (REPRO_AUTOTUNE_CACHE); nothing is written to the user's cache.  The
line before the last is the card line; the line before it the
``{"kernels": [...]}`` line; the last line ``{"ok": true, ...}``.
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


def kernels_paged():
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
            err = close(ops.paged_flash_decode(*case),
                        pa.paged_attention_ref(*case),
                        f"paged_flash_decode {shape}")
            errs[(i, dtype)] = err
            print(f"  paged_flash_decode {shape} {str(dtype)[6:]}: "
                  f"max abs err {err:.3e} (tol {TOL[dtype]})")

    # timing at the Gemma-7B shape, bf16
    case = paged_case(**gemma, dtype=torch.bfloat16, lengths=gemma_lengths)
    q, kp, vp, pt, ln = case
    ms = time_ms(lambda: ops.paged_flash_decode(*case), runs=50)
    sweep = {nw: time_ms(lambda: ops.paged_flash_decode(
        *case, num_warps=nw), runs=20) for nw in pa.NUM_WARPS}
    plain_ms = time_ms(lambda: pa.paged_attention_ref(*case), runs=20)
    B, H, D = q.shape
    T, KV = kp.shape[1], kp.shape[2]
    S = pt.shape[1] * T
    k_dense = kp[pt.long()].reshape(B, S, KV, D).transpose(1, 2).contiguous()
    v_dense = vp[pt.long()].reshape(B, S, KV, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=DEV)[None, :] < ln[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(lambda: sdpa(q4, k_dense, v_dense, attn_mask=mask),
                         runs=20)
    dev_ms = device_ms(ops.paged_flash_decode, cold_sets(lambda: paged_case(
        **gemma, dtype=torch.bfloat16, lengths=gemma_lengths)))
    lib_dev_ms = device_ms(
        lambda *a: sdpa(*a, attn_mask=mask),
        cold_sets(lambda: (q4.clone(), k_dense.clone(), v_dense.clone())))
    # least work: read q, the valid tokens' K and V rows, their page-table
    # entries and the lengths once; write the output once
    tokens = int(ln.sum())
    esize = q.element_size()
    groups = sum(-(-int(n) // T) for n in ln.tolist())
    bytes_moved = (q.numel() * esize + 2 * tokens * KV * D * esize
                   + groups * 4 + B * 4 + q.numel() * esize)
    flops = 4 * tokens * H * D  # q.k and p.v, per query head
    bound = bound_of(bytes_moved, flops)
    print(f"  gemma decode shape bf16 (the launcher's block size): plain "
          f"{plain_ms:.4f} ms ({bytes_moved} bytes, {flops} flops)")
    clocks("gemma decode shape", ms, dev_ms, bound, library_ms, lib_dev_ms,
           "sdpa")
    print("  num_warps sweep (ms): " + ", ".join(
        f"{nw}: {t:.4f}" for nw, t in sweep.items()))
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


def kernels_decode():
    g = torch.Generator(device=DEV).manual_seed(2)
    gemma = (8, 2048, 16, 16, 256, None)  # the engine's slots and cache
    shapes = [  # B, S, H, KV, D, block_kv
        (1, 32, 2, 2, 8, 16),       # the CPU tests'
        (2, 96, 8, 2, 16, 32),
        (1, 100, 4, 1, 32, 32),     # MQA + ragged cache
        (2, 80, 24, 2, 64, 32),     # 12 query heads per KV head
        (1, 4096, 16, 16, 256, None),  # train_4k's tune shape
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
    bound = bound_of(*work, flops_per_s=F32_FLOPS_PER_S)
    print(f"  zamba2 mamba2 shape f32 (B={B} S={S} H={H} dk={dk} dv={dv} "
          f"chunk {chunk}, q and k broadcast, stride 0): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, no library call, bound {bound[0]:.4f} ms "
          f"by {bound[1]} ({work[0]} bytes, {work[1]} flops at f32's "
          f"{F32_FLOPS_PER_S:.3g} flop/s; {bound[0] / ms * 100:.2f}% of the "
          f"bound); {B * H} blocks for the card's "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    clocks("zamba2 mamba2 shape", ms, dev_ms, bound)
    return record("gla", errs[(zamba, dtype)], ms, plain_ms, bound, None,
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
    return model, params, prompts, max_new, res, launches


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
    runtime = {"B": 8, "S": engine.max_groups * engine.group_tokens,
               "H": cfg.n_heads, "KV": cfg.n_kv_heads, "D": cfg.head_dim_}
    warps = ops._resolve("paged_attention", runtime, torch.bfloat16, DEV,
                         {"num_warps": None})["num_warps"]
    check(warps == tuned["num_warps"],
          f"ops resolves num_warps {warps}, the tuned entry has "
          f"{tuned['num_warps']}")
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
          f"groups; paged num_warps resolved {warps} (0 = the launcher's "
          f"choice); decode_attention tuned "
          f"{engine.kernel_blocks['decode_attention']}")
    print(f"  serve: decode {res.decode_tokens_per_sec:.2f} tok/s tuned vs "
          f"{untuned.decode_tokens_per_sec:.2f} untuned (phase 5), "
          f"{res.steps} steps, {decode_launches} decode launches; "
          f"{agree} of {total} tokens equal to the untuned run's")
    return launched


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
    gla_ms = sum(ms for k, ms in kernels.items() if "gla_kernel" in k)
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
              f"({gla_ms / n_mamba:.4f} a launch), flash kernel "
              f"{flash_ms:.4f} ms; top kernels (ms):")
        for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:.4f}  {key[:100]}")
    else:
        print("  device time per kernel: not measured (the profiler saw no "
              "device events)")
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
        print(f"[{n}/8] ({time.perf_counter() - t_start:.1f} s) {what}")

    print(f"[1/8] device: {name}; torch {torch.__version__}, "
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
            model, params, prompts, max_new, res, launches = phase_serve()
            records["paged_flash_decode"]["launches"] = launches
            phase(6, "launch.tune --tune-kernels at gemma-7b width "
                  "(slice 2's main path)")
            tuned = phase_tune()
            for name_ in ("flash_attention", "flash_decode", "rmsnorm"):
                records[name_]["launches"] = tuned[name_]
            phase(7, "gemma-7b served with autotune_kernels on that "
                  "cache")
            phase_autotune_serve(model, params, prompts, max_new, res)
            del model, params
            torch.cuda.empty_cache()
            phase(8, "zamba2-1.2b forward and loss at full width "
                  "(slice 3's main path)")
            records["gla"]["launches"] = phase_zamba()["gla"]
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
