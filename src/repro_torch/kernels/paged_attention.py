"""Paged flash-decode attention: the hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

Counterpart of ``repro.kernels.paged_attention``.  The continuous-batching
engine keeps its KV cache in a pool of fixed-size token groups
(``repro_torch.serve.paging``); a request's tokens live in whatever
groups the allocator handed it, in the logical order of its page-table
row.  The CUDA kernel (``csrc/paged_attention.cu``, which documents its
design and bound) reads the pool through the table, so no dense copy of
the cache is ever made.  It cuts each sequence into splits of
``split_tokens`` tokens (a multiple of the group size T and of the
kernel's tile), one block a (split, KV head, head tile, row); a block
streams its split's K/V rows through a TMA ring, box by box through the
page table, and the last live split of a (row, head tile) to finish
merges the partial states in split order in the same launch.  The host
never reads ``lengths``: the grid covers the pool's capacity MAXG * T
and a block past its row's length exits at once.  The block is the dense
decode kernel's (``csrc/decode_core.cuh``): 256 threads, fixed by the
design, so there is no ``num_warps``.

``paged_flash_decode_cuda`` launches the kernel for CUDA tensors and runs
``paged_attention_ref`` for CPU tensors; it counts its kernel launches in
``paged_flash_decode_cuda.launches``.  ``kernels.ref.paged_split_ref``
follows the kernel's algorithm (split partials through the page table,
merged in split order) on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as fd

__all__ = ["paged_flash_decode_cuda", "paged_attention_ref", "smem_bytes",
           "auto_split_tokens", "tile_tokens", "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = fd.HEAD_DIMS
tile_tokens = fd.tile_tokens  # the K (V) rows of one ring stage


@functools.lru_cache(maxsize=None)
def auto_split_tokens(H: int, KV: int, T: int, capacity: int, D: int,
                      esize: int, sms: int) -> int:
    """The tokens a split owns when ``split_tokens`` is None: the pool's
    capacity (MAXG * T) cut into the most splits that keep one row's
    blocks (KV * head tiles * splits) at dense decode's
    ``BLOCKS_PER_SM`` blocks an SM of ``sms`` or fewer, at least one,
    rounded up to a multiple of the group size T and of the tile
    (``scripts/kernel_phases.py --paged-splits``; ``PERF.md``).

    The batch size is not an input, by design: the host never reads the
    lengths, which are ragged, and the longest row sets the time, so
    each row is cut as if it were the only long one.  On the H100 at
    Gemma-7B's widths this is the fastest split of the sweep at B=1,
    S=4096 (256 tokens) and at the engine's mid-generation lengths
    (B=8, 128 tokens), and within 13% of the fastest at the record's
    lengths 1 to 2048 (``PERF.md``).  Cutting the capacity for
    all B rows at once (dense decode's rule) left the 2048-token row to
    two splits and ran 2.1x slower there."""
    units = KV * -(-(H // KV) // fd.head_tile(H, KV))
    n_split = max(1, fd.BLOCKS_PER_SM * sms // units)
    per_split = -(-capacity // n_split)
    step = math.lcm(T, tile_tokens(D, esize))
    return -(-per_split // step) * step


def smem_bytes(H: int, KV: int, D: int, dtype: str) -> int:
    """Dynamic shared memory of one block (the kernel has no static shared
    memory): the dense decode kernel's block, whose ring and softmax state
    the paged kernel shares (``decode_attention.smem_bytes``).  The
    library reports the compiled figure (``repro_paged_smem_bytes``);
    ``chip_smoke.py`` holds the two equal."""
    return fd.smem_bytes(H, KV, D, dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("paged_attention")
    fn = lib.repro_paged_flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_paged_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_paged_smem_bytes.restype = ctypes.c_int
    fd.bind_capture(lib)
    return lib


@functools.lru_cache(maxsize=256)
def _plan(B, H, KV, D, T, maxg, dtype, device_index, split_tokens):
    """(split_tokens, partial rows B * H * splits, merge counters) of a
    launch; the launcher's split when ``split_tokens`` is None.  Cached:
    the decode step calls the wrapper once a layer at one shape."""
    if split_tokens is None:
        split_tokens = auto_split_tokens(
            H, KV, T, maxg * T, D, 2 if dtype == torch.bfloat16 else 4,
            fd._sm_count(device_index))
    rows = B * H * -(-maxg * T // split_tokens)
    return split_tokens, rows, B * KV * -(-(H // KV) // fd.head_tile(H, KV))


def _check(q, k_pages, v_pages, page_table, lengths, split_tokens) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and the pools (G, T, KV, D);"
                         f" got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, H, D = q.shape
    G, T, KV, Dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError("k_pages and v_pages differ in shape")
    if Dk != D:
        raise ValueError(f"head dim {D} of q != {Dk} of the pools")
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported; bf16 or f32")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be (B={B}, MAXG)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be (B={B},)")
    if H % KV:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if T % 16:
        raise ValueError(f"group tokens T={T} not a multiple of 16")
    if split_tokens is not None:
        tk = tile_tokens(D, q.element_size())
        if split_tokens < 1 or split_tokens % T or split_tokens % tk:
            raise ValueError(
                f"split_tokens={split_tokens} must be a positive multiple "
                f"of the group size T={T} and of the {tk}-token tile")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_flash_decode_cuda(
    q: torch.Tensor,           # (B, H, D): one new token per sequence
    k_pages: torch.Tensor,     # (G, T, KV, D) pool; T tokens per group
    v_pages: torch.Tensor,     # (G, T, KV, D)
    page_table: torch.Tensor,  # (B, MAXG) int32: logical -> physical group
    lengths: torch.Tensor,     # (B,) int32: valid tokens per sequence
    *,
    split_tokens: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention through the page table, (B, H, D) in q's dtype;
    zeros where a length is 0.

    ``split_tokens`` is the tokens a block owns (a multiple of T and of
    the kernel's tile); None lets the launcher cut the pool's capacity to
    fill the card (``auto_split_tokens``).  It is for tests and probes:
    the tuning space has no split knob, as the reference's has none.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``paged_attention_ref``.  Nothing falls back from one to the other.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, page_table, lengths, split_tokens)
    B, H, D = q.shape
    G, T, KV, _ = k_pages.shape
    maxg = page_table.shape[1]
    dev = q.device
    split_tokens, rows, n_units = _plan(B, H, KV, D, T, maxg, q.dtype,
                                        dev.index or 0, split_tokens)
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, counters = fd._scratch(dev, stream,
                                     lib.repro_decode_capture(stream),
                                     rows * (D + 2), n_units)
    part = partials.data_ptr()
    err = lib.repro_paged_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), part, part + 4 * rows,
        part + 8 * rows, counters.data_ptr(), out.data_ptr(), B, H, KV, D,
        G, T, maxg, build.DTYPE_CODE[q.dtype], split_tokens, stream)
    if err:
        raise RuntimeError(
            f"paged decode kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} "
            f"(B={B} H={H} KV={KV} D={D} T={T} split_tokens={split_tokens})")
    paged_flash_decode_cuda.launches += 1
    return out


paged_flash_decode_cuda.launches = 0


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """Plain PyTorch version: gather the pool into logical order, then
    masked attention (the reference's ``paged_attention_ref``)."""
    B, H, D = q.shape
    G_pool, T, KV, _ = k_pages.shape
    pt = page_table.long()
    k = k_pages[pt].reshape(B, -1, KV, D).float()
    v = v_pages[pt].reshape(B, -1, KV, D).float()
    Gq = H // KV
    qg = q.reshape(B, KV, Gq, D).float() / math.sqrt(D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k)
    kpos = torch.arange(k.shape[1], device=q.device)
    valid = kpos[None, None, None, :] < lengths.to(q.device)[:, None, None,
                                                             None]
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(B, H, D).to(q.dtype)
