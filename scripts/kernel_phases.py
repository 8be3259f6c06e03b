#!/usr/bin/env python3
"""Device time of the dense decode and GLA kernels by CUDA kernel, at their
record shapes, on one NVIDIA GPU.

    python3 scripts/kernel_phases.py [--root DIR] [--decode-splits]

``--root`` times the ``repro_torch`` of another checkout of this
repository (an unpacked older commit, say), with that checkout's own
``chip_smoke.py`` clock, so two versions are timed on one card in one run;
its kernels build into that checkout's own ``build/``.  For each case the
script prints one JSON line: ``device_ms``, the device time of a call by
``chip_smoke.device_ms`` (a CUDA graph of 32 calls rotating among the
L2-cold input sets of ``chip_smoke.cold_sets``: no host work is timed),
and ``kernels``, the device ms a call of each CUDA kernel the call
launched (its phases: a split and a merge kernel, or chunk states, scan
and outputs) from ``torch.profiler`` over one pass through the sets; for
decode also SDPA's ``device_ms`` on the same inputs.  ``--decode-splits``
also times decode with the cache cut into 1 to 48 splits (block_kv =
ceil(S / splits)), against the blocks the card holds at once.  The first
line is the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--decode-splits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs  # puts the checkout's src/ on the path
    from repro_torch.kernels import ops

    def report(case, fn, sets, **extra):
        print(json.dumps({"case": case, "device_ms": cs.device_ms(fn, sets),
                          "kernels": kernel_split(fn, sets), **extra}),
              flush=True)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"root": args.root}))
    g = torch.Generator(device=cs.DEV).manual_seed(0)

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
            sms = torch.cuda.get_device_properties(0).multi_processor_count
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
