#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):

1. device   - the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build    - every kernel source under src/repro_torch/kernels/csrc, built
              anew (one nvcc each, all at once) even where a library of it
              is already built; each build's seconds.
3. kernels  - each kernel against its plain PyTorch version on the card, at
              the Gemma-7B shapes and the CPU tests' shapes, in bf16 and
              f32; every config of each tuning space (KernelSpace) that
              fits the card launched once at a Gemma-width shape and held
              to the plain version, and its shared memory as the library
              reports it held to the space's smem_footprint; each kernel
              timed at its Gemma-7B shape beside its bound, the plain
              version and one PyTorch library call.
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

Launch counts are set to 0 just before each main path (phases 5, 6 and 7)
and read just after.  The autotune cache of the whole run is a temporary
file (REPRO_AUTOTUNE_CACHE); nothing is written to the user's cache.  The
line before the last is the card line; the line before it the
``{"kernels": [...]}`` line; the last line ``{"ok": true, ...}``.
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
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
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.ref import attention_ref, rmsnorm_ref  # noqa: E402
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
# the tune phase's budget per kernel (tests, each a warm-up and 3 timed
# launches); the serve engine tunes its own shapes at its default budget
TUNE_BUDGET = 8
# kernel record name -> its wrapper, whose launch count the paths read
WRAPPERS = {
    "paged_flash_decode": pa.paged_flash_decode_cuda,
    "flash_attention": fa.flash_attention_cuda,
    "flash_decode": fd.flash_decode_cuda,
    "rmsnorm": rn.rmsnorm_cuda,
}
SOURCES = {
    "paged_flash_decode": ("paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:108"),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "flash_decode": ("decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:71"),
    "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:28"),
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


# ---------------------------------------------------------------------------
# bounds and library yardsticks
# ---------------------------------------------------------------------------
def bound_of(bytes_moved: float, flops: float):
    """(least ms, what binds it) at the H100 SXM's published peaks."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
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


def sdpa(q4, k4, v4, **kw):
    return torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, enable_gqa=q4.shape[1] != k4.shape[1], **kw)


def rnd(g, shape, dtype):
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def close(got, want, what) -> float:
    """Max abs error of a kernel against its plain version; fails unless
    every element is within the CPU tests' tolerance."""
    torch.cuda.synchronize()
    tol = TOL[want.dtype]
    err = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"{what}: kernel disagrees with plain version: max abs err "
          f"{float(err.max()):.3e} > tol {tol}")
    return float(err.max())


def record(name, err, ms, plain_ms, bound, library_ms):
    src, replaces = SOURCES[name]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


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
    # least work: read q, the valid tokens' K and V rows, their page-table
    # entries and the lengths once; write the output once
    tokens = int(ln.sum())
    esize = q.element_size()
    groups = sum(-(-int(n) // T) for n in ln.tolist())
    bytes_moved = (q.numel() * esize + 2 * tokens * KV * D * esize
                   + groups * 4 + B * 4 + q.numel() * esize)
    flops = 4 * tokens * H * D  # q.k and p.v, per query head
    bound = bound_of(bytes_moved, flops)
    print(f"  gemma decode shape bf16: kernel {ms:.4f} ms (launcher's "
          f"block size), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms,"
          f" bound {bound[0]:.4f} ms ({bytes_moved} bytes, {flops} flops; "
          f"{bound[0] / ms * 100:.1f}% of the bound)")
    print("  num_warps sweep (ms): " + ", ".join(
        f"{nw}: {t:.4f}" for nw, t in sweep.items()))
    return record("paged_flash_decode", errs[(0, torch.bfloat16)], ms,
                  plain_ms, bound, library_ms)


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
            print(f"  flash_attention {shape[:9]} {str(dtype)[6:]}: max abs "
                  f"err {err:.3e} (tol {TOL[dtype]})")
            del q, k, v, got, want
    B, S, SK, H, KV, D = gemma[:6]
    dtype = torch.bfloat16
    q, k, v = (rnd(g, (B, S, H, D), dtype), rnd(g, (B, SK, KV, D), dtype),
               rnd(g, (B, SK, KV, D), dtype))
    ms = time_ms(lambda: ops.flash_attention(q, k, v), runs=10)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), runs=5)
    q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), runs=10)
    work = flash_work(B, S, SK, H, KV, D, q.element_size())
    bound = bound_of(*work)
    print(f"  gemma train_4k bf16 (B={B} S={S} H={H} D={D}, causal, "
          f"default tiles): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound[0]:.4f} ms by "
          f"{bound[1]} ({work[0]} bytes, {work[1]} flops; "
          f"{bound[0] / ms * 100:.2f}% of the bound)")
    return record("flash_attention", errs[(gemma, dtype)], ms, plain_ms,
                  bound, library_ms)


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
    work = decode_work(B, H, KV, D, S, q.element_size())
    bound = bound_of(*work)
    print(f"  gemma engine decode shape bf16 (B={B} S={S} full, default "
          f"block_kv): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
          f"({work[0]} bytes; {bound[0] / ms * 100:.1f}% of the bound)")
    return record("flash_decode", errs[(gemma, S, dtype)], ms, plain_ms,
                  bound, library_ms)


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
    rows, D = gemma[0]
    x = rnd(g, (rows, D), torch.bfloat16)
    s = torch.randn(D, generator=g, device=DEV)
    ms = time_ms(lambda: ops.rmsnorm(x, s), runs=50)
    plain_ms = time_ms(lambda: rmsnorm_ref(x, s), runs=20)
    s_lib = s.to(x.dtype)
    library_ms = time_ms(lambda: torch.nn.functional.rms_norm(
        x, (D,), weight=s_lib, eps=1e-6), runs=20)
    work = rms_work(rows, D, x.element_size())
    bound = bound_of(*work)
    print(f"  gemma train_4k rows bf16 (ROWS={rows} D={D}, default "
          f"block_rows): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.rms_norm {library_ms:.4f} ms, bound {bound[0]:.4f} ms by "
          f"{bound[1]} ({work[0]} bytes; {bound[0] / ms * 100:.1f}% of the "
          f"bound)")
    return record("rmsnorm", errs[(gemma[0], torch.bfloat16)], ms, plain_ms,
                  bound, library_ms)


# Gemma-width shapes for the sweep over each tuning space's configs: the
# model's heads and head dim (or d_model), ragged against every tile.
SWEEP_DIMS = {
    "flash_attention": {"B": 1, "S": 320, "SK": 320, "H": 16, "KV": 16,
                        "D": 256},
    "decode_attention": {"B": 2, "S": 1000, "H": 16, "KV": 16, "D": 256},
    "paged_attention": {"B": 2, "S": 1000, "H": 16, "KV": 16, "D": 256},
    "rmsnorm": {"ROWS": 250, "D": 3072},
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
    return max(rn._lib().repro_rmsnorm_smem_bytes(code, code_s, vec)
               for code_s in {0, code} for vec in (0, 1))


def sweep_spaces():
    """Every config of each tuning space: the library's shared memory
    equals smem_footprint (both dtypes); each config the card's opt-in
    limit admits launches through the tuner's own call adapter at a
    Gemma-width shape and agrees with the plain version."""
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
        inputs = kdef.make_inputs(dims, "bfloat16", rng, DEV)
        if kernel == "flash_attention":
            want = attention_ref(*inputs)
        elif kernel == "decode_attention":
            want = fd.decode_attention_ref(*inputs)
        elif kernel == "paged_attention":
            want = fd.decode_attention_ref(inputs["q"], inputs["k"],
                                           inputs["v"], inputs["kv_len"])
        else:
            want = rmsnorm_ref(*inputs)
        feasible = kernel_feasibility(kernel, dims, "bfloat16",
                                      smem_limit=limit)
        n_run = worst = 0
        for cfg in grid:
            if not feasible(cfg):
                continue
            err = close(kdef.call(inputs, cfg), want, f"{kernel} {cfg}")
            worst = max(worst, err)
            n_run += 1
        print(f"  {kernel} space: {len(grid)} configs, shared memory "
              f"equal to smem_footprint for each (bf16, f32); {n_run} fit "
              f"the card's {limit} bytes a block and agree with the plain "
              f"version at {autotune.shape_sig(dims)} bf16 (max abs err "
              f"{worst:.3e})")


def phase_kernels():
    records = {"paged_flash_decode": kernels_paged(),
               "flash_attention": kernels_flash(),
               "flash_decode": kernels_decode(),
               "rmsnorm": kernels_rmsnorm()}
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
    for name in WRAPPERS:
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
        # the whole space on the card, by the same clock: how close the
        # tuner's budget got to the grid's best
        feasible = kernel_feasibility(kernel, dims, cfg.compute_dtype,
                                      smem_limit=autotune.smem_limit(DEV))
        space = autotune.KernelSpace(kernel).space()
        grid = {}
        for vals in itertools.product(*(space[n].choices
                                        for n in space.names)):
            c = dict(zip(space.names, vals))
            if feasible(c):
                grid[tuple(vals)] = time_ms(lambda: kdef.call(inputs, c),
                                            runs=3 if runs == 5 else 10,
                                            warmup=1)
        ranked = sorted(grid.values())
        best = min(grid, key=grid.get)
        won = grid[tuple(winner[n] for n in space.names)]
        dflt = grid[tuple(default[n] for n in space.names)]
        print(f"    grid: {len(grid)} configs fit; best "
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
    print(f"[1/7] device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "cache.json")
        autotune.reset_default_cache()
        try:
            built = build.build_all(force=True)
            print("[2/7] build (one nvcc a source, all at once):")
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
            print("[3/7] kernels against their plain versions")
            records = phase_kernels()
            print("[4/7] port on the card against the port on the cpu")
            phase_parity()
            print("[5/7] gemma-7b at full width (slice 1's main path)")
            model, params, prompts, max_new, res, launches = phase_serve()
            records["paged_flash_decode"]["launches"] = launches
            print("[6/7] launch.tune --tune-kernels at gemma-7b width "
                  "(slice 2's main path)")
            tuned = phase_tune()
            for name_ in ("flash_attention", "flash_decode", "rmsnorm"):
                records[name_]["launches"] = tuned[name_]
            print("[7/7] gemma-7b served with autotune_kernels on that "
                  "cache")
            phase_autotune_serve(model, params, prompts, max_new, res)
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
