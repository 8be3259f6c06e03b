"""Public entry points of the port's kernels.

Counterpart of ``repro.kernels.ops``.  Launch knobs resolve per call:
an explicit argument wins, else ``DEFAULT_BLOCKS``.  The reference also
consults its autotune cache between those two; the port's autotune cache
is a later slice (ROADMAP queue 1, item 4), so it is not consulted here.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs
its plain PyTorch version for CPU tensors; the wrapper counts its kernel
launches (``paged_attention.paged_flash_decode_cuda.launches``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .paged_attention import paged_flash_decode_cuda

__all__ = ["paged_flash_decode", "DEFAULT_BLOCKS"]

# num_warps is the CUDA block size (num_warps * 32 threads) of the paged
# decode kernel.  None leaves it to the launcher, which takes the most
# warps each instantiation's register use allows (PERF.md); a value here
# or from the caller overrides that, and is the knob the autotune slice
# will fill.  The reference's pages_per_block is the pool's group size
# and is fixed by the engine (ServeConfig.kv_page_block), not here.
DEFAULT_BLOCKS: Dict[str, Dict[str, Any]] = {
    "paged_attention": {"num_warps": None},
}


def _resolve(kernel: str, overrides: Dict[str, Optional[int]]
             ) -> Dict[str, Any]:
    """Explicit override > builtin default, per knob."""
    blocks = dict(DEFAULT_BLOCKS[kernel])
    blocks.update({k: v for k, v in overrides.items() if v is not None})
    return blocks


def paged_flash_decode(q, k_pages, v_pages, page_table, lengths, *,
                       num_warps: Optional[int] = None):
    """Paged decode attention over a (groups, tokens, KV, D) pool:
    q (B, H, D), page_table (B, MAXG) int32, lengths (B,) int32 ->
    (B, H, D) in q's dtype."""
    blocks = _resolve("paged_attention", {"num_warps": num_warps})
    return paged_flash_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                                   num_warps=blocks["num_warps"])
