"""Public entry points of the port's kernels.

Counterpart of ``repro.kernels.ops``.  Launch knobs resolve per call, knob
by knob: an explicit argument wins, else the autotune cache's entry for
(kernel, problem signature, dtype, backend), else ``DEFAULT_BLOCKS``
(``repro_torch.autotune``).  The resolution is memoized per (cache file,
kernel, signature, dtype, device) and the memo is dropped whenever a
cache is written or reloaded, so a decode step's 28 calls cost a dict
lookup each after the first.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs
its plain PyTorch version for CPU tensors; each counts its kernel
launches (``<wrapper>.launches``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import autotune

from .decode_attention import flash_decode_cuda
from .flash_attention import flash_attention_cuda
from .gla import gla_cuda
from .paged_attention import paged_flash_decode_cuda
from .rmsnorm import rmsnorm_cuda

__all__ = ["flash_attention", "flash_decode", "paged_flash_decode",
           "rmsnorm", "gla", "DEFAULT_BLOCKS"]

# num_warps 0 leaves the CUDA block size to each kernel's launcher, which
# takes the most warps the kernel's registers allow (bounded by the
# tile's rows); the tile sizes are each kernel space's default.  Flash
# attention's default is the fastest tile pair of the card's bf16 grid at
# Gemma-7B's train_4k among those that fit a block in both dtypes at
# D=256 (PERF.md).  Flash attention, dense and paged decode and GLA have
# no num_warps knob: their designs fix the block.  Dense decode's
# block_kv 0 leaves the split to its launcher, which cuts the cache to
# fill the card.  pages_per_block is the pool's group size: the serve
# engine resolves it when it lays the pool out (the allocator group IS
# the kernel's page tile), so nothing of paged decode resolves here.
DEFAULT_BLOCKS: Dict[str, Dict[str, Any]] = {
    "flash_attention": {"block_q": 64, "block_kv": 32},
    "decode_attention": {"block_kv": 0},
    "paged_attention": {"pages_per_block": 4},
    "rmsnorm": {"block_rows": 4, "num_warps": 0},
    "gla": {"chunk": 128},
}

_memo: Dict[Tuple, Dict[str, Any]] = {}
_memo_generation = -1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tuned(kernel: str, dims: Dict[str, int], dtype: torch.dtype,
           device: torch.device) -> Dict[str, Any]:
    """Autotune cache > builtin default, memoized until a cache write.

    The memo key names the cache file by the variable that chooses it
    (``default_cache()`` follows it), so a hit costs a few dict lookups:
    the eager decode step resolves 28 times a step on a host-bound path.
    """
    global _memo_generation
    if autotune.generation() != _memo_generation:
        _memo.clear()
        _memo_generation = autotune.generation()
    key = (os.environ.get("REPRO_AUTOTUNE_CACHE"), kernel,
           tuple(dims.items()), dtype, device)
    blocks = _memo.get(key)
    if blocks is None:
        blocks = _memo[key] = autotune.resolve_blocks(
            kernel, dims, _dtype_name(dtype), DEFAULT_BLOCKS[kernel],
            backend=autotune.backend_name(device))
    return blocks


def _resolve(kernel: str, dims: Dict[str, int], dtype: torch.dtype,
             device: Union[str, torch.device],
             overrides: Dict[str, Optional[int]]) -> Dict[str, Any]:
    """Explicit override > autotune cache > builtin default, per knob."""
    if any(v is None for v in overrides.values()):
        blocks = dict(_tuned(kernel, dims, dtype, torch.device(device)))
    else:
        blocks = dict(DEFAULT_BLOCKS[kernel])
    blocks.update({k: v for k, v in overrides.items() if v is not None})
    return blocks


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, block_q: Optional[int] = None,
                    block_kv: Optional[int] = None):
    """GQA attention: q (B, Sq, H, D), k and v (B, Sk, KV, D) ->
    (B, Sq, H, D) in q's dtype."""
    B, S, H, D = q.shape
    # SK (the KV sequence length) enters the signature: cross-attention
    # and cache-prefill calls share S but differ in k.shape[1]
    blocks = _resolve(
        "flash_attention",
        {"B": B, "S": S, "SK": k.shape[1], "H": H, "KV": k.shape[2],
         "D": D}, q.dtype, q.device,
        {"block_q": block_q, "block_kv": block_kv})
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset,
                                block_q=blocks["block_q"],
                                block_kv=blocks["block_kv"])


def rmsnorm(x, scale, *, eps: float = 1e-6,
            block_rows: Optional[int] = None,
            num_warps: Optional[int] = None):
    """RMSNorm over the last axis of x (..., d), in x's dtype."""
    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    blocks = _resolve("rmsnorm", {"ROWS": rows, "D": x.shape[-1]}, x.dtype,
                      x.device,
                      {"block_rows": block_rows, "num_warps": num_warps})
    return rmsnorm_cuda(x, scale, eps=eps, block_rows=blocks["block_rows"],
                        num_warps=blocks["num_warps"])


def gla(q, k, v, log_g, *, chunk: Optional[int] = None):
    """Chunked gated linear attention from a zero state: q and k
    (B, S, H, dk), v (B, S, H, dv), log_g (B, S, H) -> (y (B, S, H, dv) in
    v's dtype, final state (B, H, dk, dv) f32)."""
    B, S, H, dk = q.shape
    blocks = _resolve("gla", {"B": B, "S": S, "H": H, "DK": dk,
                              "DV": v.shape[-1]}, q.dtype, q.device,
                      {"chunk": chunk})
    return gla_cuda(q, k, v, log_g, chunk=blocks["chunk"])


def flash_decode(q, k, v, kv_len, *, block_kv: Optional[int] = None):
    """Decode attention over a dense cache: q (B, H, D), k and v
    (B, S, KV, D), ``kv_len`` valid entries (an int or a 0-d int32 tensor
    on q's device) -> (B, H, D) in q's dtype."""
    B, H, D = q.shape
    blocks = _resolve(
        "decode_attention",
        {"B": B, "S": k.shape[1], "H": H, "KV": k.shape[2], "D": D},
        q.dtype, q.device, {"block_kv": block_kv})
    return flash_decode_cuda(q, k, v, kv_len, block_kv=blocks["block_kv"])


def paged_flash_decode(q, k_pages, v_pages, page_table, lengths):
    """Paged decode attention over a (groups, tokens, KV, D) pool:
    q (B, H, D), page_table (B, MAXG) int32, lengths (B,) int32 ->
    (B, H, D) in q's dtype.

    The pool's group size (``pages_per_block``) is baked into its layout
    by the caller (the serve engine sizes its allocator groups from the
    tuned config); the kernel has no other launch knob, so nothing
    resolves here and a decode step's 28 calls pay no lookup.
    """
    return paged_flash_decode_cuda(q, k_pages, v_pages, page_table, lengths)
