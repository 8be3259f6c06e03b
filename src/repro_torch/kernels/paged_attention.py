"""Paged flash-decode attention: the hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

Counterpart of ``repro.kernels.paged_attention``.  The continuous-batching
engine keeps its KV cache in a pool of fixed-size token groups
(``repro_torch.serve.paging``); a request's tokens live in whatever
groups the allocator handed it, in the logical order of its page-table
row.  The CUDA kernel (``csrc/paged_attention.cu``, which documents its
design and bound) reads the pool through the table, so no dense copy of
the cache is ever made.

``paged_flash_decode_cuda`` launches the kernel for CUDA tensors and runs
``paged_attention_ref`` for CPU tensors; it counts its kernel launches in
``paged_flash_decode_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["paged_flash_decode_cuda", "paged_attention_ref", "smem_bytes",
           "HEAD_DIMS", "NUM_WARPS"]

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
NUM_WARPS = (1, 2, 4, 8, 16, 32)
MAX_HEAD_TILE = 8


def smem_bytes(heads: int, kv_heads: int, head_dim: int) -> int:
    """Static shared memory of one block: per-warp (m, l) for 32 warps
    and the merged acc and (m, l) of a head tile, f32.  The library
    reports the compiled kernel's own figure (``repro_paged_smem_bytes``);
    ``chip_smoke.py`` holds the two equal."""
    g = heads // kv_heads
    tile = 1
    while tile < g and tile < MAX_HEAD_TILE:
        tile *= 2
    return (2 * 32 * tile + tile * max(head_dim, 32) + 2 * tile) * 4


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("paged_attention")
    fn = lib.repro_paged_flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_paged_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_paged_smem_bytes.restype = ctypes.c_int
    return lib


def _check(q, k_pages, v_pages, page_table, lengths, num_warps) -> None:
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
    if num_warps is not None and num_warps not in NUM_WARPS:
        raise ValueError(f"num_warps={num_warps} not in {NUM_WARPS}")
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
    num_warps: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention through the page table, (B, H, D) in q's dtype.

    ``num_warps`` sets the CUDA block size; None (or 0) lets the
    launcher take the most warps (up to 32) that the instantiation for
    this head dim and head tile can launch with its register use.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``paged_attention_ref``.  Nothing falls back from one to the other.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    num_warps = num_warps or None
    _check(q, k_pages, v_pages, page_table, lengths, num_warps)
    B, H, D = q.shape
    G, T, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_paged_flash_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H, KV,
        D, G, T, page_table.shape[1], build.DTYPE_CODE[q.dtype],
        num_warps or 0, stream)
    if err:
        raise RuntimeError(
            f"paged decode kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} "
            f"(B={B} H={H} KV={KV} D={D} T={T} "
            f"num_warps={num_warps or 'auto'})")
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
