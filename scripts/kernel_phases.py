#!/usr/bin/env python3
"""Device time of the paged decode, dense decode and GLA kernels by CUDA
kernel, at their record shapes, on one NVIDIA GPU.

    python3 scripts/kernel_phases.py [--root DIR] [--decode-splits]
                                     [--paged-splits]

``--root`` times the ``repro_torch`` of another checkout of this
repository (an unpacked older commit, say), with that checkout's own
``chip_smoke.py`` clock, so two versions are timed on one card in one run;
its kernels build into that checkout's own ``build/``.  For each case the
script prints one JSON line: ``device_ms``, the device time of a call by
``chip_smoke.device_ms`` (a CUDA graph of 32 calls rotating among the
L2-cold input sets of ``chip_smoke.cold_sets``: no host work is timed),
and ``kernels``, the device ms a call of each CUDA kernel the call
launched (its phases: a split and a merge kernel, or chunk states, scan
and outputs) from ``torch.profiler`` over one pass through the sets.  For
the decode kernels also SDPA's ``device_ms`` on the same inputs (for
paged decode on the K/V gathered through the page table, masked past each
row's length).  For paged decode also ``host_paced_ms``
(``chip_smoke.time_ms``: events around back-to-back calls) and
``host_us``, the host's microseconds a call issued back to back (the
wrapper's work and the launch; the least of seven rounds).

Paged decode runs at Gemma-7B's widths (16 heads of 256, bf16): the
record shape (B=8, 16-token groups, lengths 1 to 2048), the engine's
mid-generation shape (``chip_smoke.profile_decode_step``'s lengths) and
B=1 at 4096 tokens in groups of 16 and of 64.  ``--decode-splits`` also
times dense decode with the cache cut into 1 to 48 splits (block_kv =
ceil(S / splits)); ``--paged-splits`` times paged decode at each
``split_tokens`` of a sweep (on a checkout whose wrapper takes it), both
against the blocks the card holds at once, and the record's lengths in a
pool of twice the capacity at the launcher's split (twice the blocks
that exit at once, the same live ones).  The first line is the card's
name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def kernel_split(fn, sets):
    """{kernel name: device ms a call} from ``torch.profiler`` over one
    pass of ``fn(*inputs)`` through ``sets``."""
    from torch.profiler import ProfilerActivity, profile

    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for s in sets:
            fn(*s)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            key = e.key[:80]
            out[key] = out.get(key, 0.0) + dt / 1e3 / len(sets)
    return out


def host_us(fn, inputs, calls=100, rounds=7):
    """Host microseconds a call: the least, over ``rounds``, of the wall
    time of ``calls`` calls issued back to back with no sync between them
    (the wrapper's work and the launch; the card drains the queue behind
    the host), after a warm-up.  The least round is the one the host's
    other work disturbed least."""
    for _ in range(10):
        fn(*inputs)
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn(*inputs)
        best = min(best, (time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def paged_cases(cs):
    """(name, paged_case kwargs) of the paged decode cases."""
    gemma = dict(B=8, H=16, KV=16, D=256, T=16, maxg=128)
    plens = np.random.default_rng(cs.SEED).integers(128, 513, size=8)
    engine = [int(n) + 16 for n in plens]  # phase 5's mid-generation
    return [
        ("record", dict(gemma, lengths=[1, 16, 17, 2048, 300, 777, 1500,
                                        64])),
        ("engine", dict(gemma, lengths=engine)),
        ("B=1 S=4096 T=16", dict(B=1, H=16, KV=16, D=256, T=16, maxg=256,
                                 lengths=[4096])),
        ("B=1 S=4096 T=64", dict(B=1, H=16, KV=16, D=256, T=64, maxg=64,
                                 lengths=[4096])),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--decode-splits", action="store_true")
    ap.add_argument("--paged-splits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs  # puts the checkout's src/ on the path
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    def report(case, fn, sets, **extra):
        print(json.dumps({"case": case, "device_ms": cs.device_ms(fn, sets),
                          "kernels": kernel_split(fn, sets), **extra}),
              flush=True)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"root": args.root}))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=cs.DEV).manual_seed(0)

    # paged decode at Gemma-7B's widths, bf16
    takes_split = ("split_tokens" in
                   inspect.signature(pa.paged_flash_decode_cuda).parameters)
    for name, kw in paged_cases(cs):
        sets = cs.cold_sets(lambda: cs.paged_case(**kw, dtype=torch.bfloat16))
        B, T, S = kw["B"], kw["T"], kw["maxg"] * kw["T"]
        ln = sets[0][4]
        mask = (torch.arange(S, device=cs.DEV)[None, :] < ln[:, None].long()
                )[:, None, None, :]

        def gathered(q, kp, vp, pt, _):
            k, v = (p[pt.long()].reshape(B, S, 16, 256).transpose(1, 2)
                    .contiguous() for p in (kp, vp))
            return q[:, :, None], k, v

        sdpa_sets = [gathered(*s) for s in sets]
        sdpa_ms = cs.device_ms(
            lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), sdpa_sets)
        del sdpa_sets
        report(f"paged_flash_decode {name} (B={B} T={T} lengths "
               f"{kw['lengths']}) H=KV=16 D=256 bf16",
               ops.paged_flash_decode, sets, sdpa_device_ms=sdpa_ms,
               host_paced_ms=cs.time_ms(
                   lambda: ops.paged_flash_decode(*sets[0]), runs=50),
               host_us=host_us(ops.paged_flash_decode, sets[0]))
        if args.paged_splits and takes_split:
            auto = pa.auto_split_tokens(16, 16, T, S, 256, 2, sms)
            step = int(np.lcm(T, pa.tile_tokens(256, 2)))
            for st in sorted({step * m for m in (1, 2, 4, 8, 16, 32, 64,
                                                 128, 256)
                              if step * m <= S} | {auto}):
                n_split = -(-S // st)
                live = sum(-(-n // st) for n in kw["lengths"]) * 16
                report(f"paged_flash_decode {name} split_tokens {st}"
                       f"{' (auto)' if st == auto else ''} ({B * 16 * n_split}"
                       f" blocks, {live} live, {sms} SMs)",
                       lambda *a: pa.paged_flash_decode_cuda(
                           *a, split_tokens=st), sets)
            if name == "record":  # the cost of blocks past the lengths
                wide = cs.cold_sets(lambda: cs.paged_case(
                    **dict(kw, maxg=2 * kw["maxg"]), dtype=torch.bfloat16))
                report(f"paged_flash_decode record at twice the capacity, "
                       f"split_tokens {auto} ({2 * B * 16 * -(-S // auto)} "
                       f"blocks, the same live ones)",
                       lambda *a: pa.paged_flash_decode_cuda(
                           *a, split_tokens=auto), wide)
                del wide
        del sets

    # GLA: Zamba2-1.2B's Mamba2 layer, f32, q and k broadcast over heads
    sets = cs.cold_sets(lambda: cs.gla_case(g, 1, 4096, 64, 64, 64,
                                            torch.float32, True))
    report("gla B=1 S=4096 H=64 dk=dv=64 f32 chunk 256 broadcast q,k",
           lambda *a: ops.gla(*a, chunk=256), sets)
    del sets

    # dense decode: the Gemma-7B engine shape and the tune shape, bf16
    for B, S in ((8, 2048), (1, 4096)):
        kl = torch.tensor(S, dtype=torch.int32, device=cs.DEV)
        sets = cs.cold_sets(lambda: (
            cs.rnd(g, (B, 16, 256), torch.bfloat16),
            cs.rnd(g, (B, S, 16, 256), torch.bfloat16),
            cs.rnd(g, (B, S, 16, 256), torch.bfloat16), kl))
        sdpa_sets = [(q[:, :, None], k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous()) for q, k, v, _ in sets]
        sdpa_ms = cs.device_ms(
            torch.nn.functional.scaled_dot_product_attention, sdpa_sets)
        del sdpa_sets
        report(f"flash_decode B={B} S={S} H=KV=16 D=256 bf16",
               ops.flash_decode, sets, sdpa_device_ms=sdpa_ms)
        if args.decode_splits:
            for n_split in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 40,
                            48):
                bkv = -(-S // n_split)
                report(f"flash_decode B={B} S={S} {n_split} splits "
                       f"(block_kv {bkv}, {B * 16 * n_split} blocks, "
                       f"{sms} SMs)",
                       lambda *a: ops.flash_decode(*a, block_kv=bkv), sets)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
