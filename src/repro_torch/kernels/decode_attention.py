"""Flash-decode attention over a dense KV cache: the hand-written CUDA
kernel, its wrapper and its plain PyTorch version.

Counterpart of ``repro.kernels.decode_attention``: one query token per
sequence against a (B, S, KV, D) cache of which the first ``kv_len``
entries (one scalar for the batch) are valid.  The CUDA kernel
(``csrc/decode_attention.cu``, which documents its design and bound)
splits the cache axis into blocks of ``block_kv`` entries, streams each
split's K/V through a TMA ring in shared memory, and merges the splits in
the same launch: the last block of a (row, KV head) to finish merges the
partial states in split order.  ``kv_len`` may be a Python int or a 0-d
int32 device tensor; the kernel reads the tensor on the device, so the
host never waits for it.

``flash_decode_cuda`` launches the kernel for CUDA tensors and runs
``decode_attention_ref`` for CPU tensors; it counts its launches in
``flash_decode_cuda.launches``.  ``kernels.ref.decode_split_ref`` follows
the kernel's algorithm (split partials merged in split order) on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import build

__all__ = ["flash_decode_cuda", "decode_attention_ref", "smem_bytes",
           "tile_tokens", "head_tile", "auto_block_kv", "HEAD_DIMS",
           "STAGES", "THREADS", "BLOCKS_PER_SM"]

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
THREADS = 256        # the block: fixed by the design, no num_warps knob
STAGES = 4           # K/V tiles in flight a block
TILE_BYTES = 8192    # the most bytes of one K (or V) tile
MAX_HEAD_TILE = 8    # query heads a block scores from one K/V tile
# block_kv 0 cuts the cache into as many splits as keep the grid at this
# many blocks an SM or fewer: at Gemma-7B's widths the fastest split count
# at both B=8, S=2048 and B=1, S=4096 (scripts/kernel_phases.py
# --decode-splits; PERF.md)
BLOCKS_PER_SM = 2
_ALIGN = 128         # of a TMA box's shared-memory destination

# the scratch of each (device, stream): the capture it serves (0: eager
# launches), the decode kernels' partial states and merge counters (zero
# between launches)
_SCRATCH: Dict[Tuple[int, int], Tuple[int, torch.Tensor, torch.Tensor]] = {}


def tile_tokens(D: int, esize: int) -> int:
    """Cache entries of one K (or V) tile: 8 KB of rows, at most 128."""
    return min(128, TILE_BYTES // (D * esize))


def head_tile(H: int, KV: int) -> int:
    """Query heads a block takes: the power of two >= H / KV, at most 8."""
    t = 1
    while t < H // KV and t < MAX_HEAD_TILE:
        t <<= 1
    return t


def auto_block_kv(B: int, S: int, H: int, KV: int, D: int, esize: int,
                  sms: int) -> int:
    """The entries a split owns when ``block_kv`` is 0: S cut into the most
    splits that keep the grid (B * KV * head tiles * splits blocks) at
    ``BLOCKS_PER_SM`` blocks an SM of ``sms`` or fewer, at least one,
    rounded up to whole tiles."""
    units = B * KV * -(-(H // KV) // head_tile(H, KV))
    n_split = max(1, BLOCKS_PER_SM * sms // units)
    per_split = -(-S // n_split)
    tk = tile_tokens(D, esize)
    return min(S, -(-per_split // tk) * tk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def smem_bytes(H: int, KV: int, D: int, dtype: str) -> int:
    """Dynamic shared memory of one block (the kernel has no static shared
    memory): alignment slack, the ring of ``STAGES`` K and V tiles (at
    least two floats a thread and head: the token groups' sums meet there
    at the end), the scaled f32 query and the tile's scores of the head
    tile, four softmax floats a head, the stages' barriers and the
    last-block flag.  ``csrc/decode_core.cuh::smem_bytes`` is the same
    formula; ``chip_smoke.py`` holds the two equal."""
    esize = 2 if dtype == "bfloat16" else 4
    tk, gq = tile_tokens(D, esize), head_tile(H, KV)
    ring = max(STAGES * 2 * tk * D * esize, 2 * THREADS * gq * 4)
    return (_ALIGN + ring + gq * D * 4 + gq * tk * 4 + 16 * gq + STAGES * 8
            + 8)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("decode_attention")
    fn = lib.repro_flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_flash_decode_smem_bytes.restype = ctypes.c_int
    bind_capture(lib)
    return lib


def bind_capture(lib) -> None:
    """Binds ``repro_decode_capture`` (``csrc/decode_core.cuh``), which
    both decode libraries export: the key of the CUDA-graph capture under
    way on a stream, 0 when none."""
    lib.repro_decode_capture.argtypes = [ctypes.c_void_p]
    lib.repro_decode_capture.restype = ctypes.c_ulonglong


def _scratch(device: torch.device, stream: int, capture: int,
             n_partials: int,
             n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scratch of a decode launch on ``stream``: at least
    ``n_partials`` f32 for the splits' partial states (m, l, acc) and at
    least ``n_counters`` int32 merge counters, zero between launches (the
    kernels leave every counter at zero).

    One pair a (device, stream), for the eager launches on it (``capture``
    0) or for one CUDA-graph capture on it (``capture``, the library's
    ``repro_decode_capture``), grown as needed.  The launches that share a
    pair run in order and each merges its partials before it ends; a
    decode step pays no allocation a layer.  Launches on two streams never
    share a pair, and neither do two captures, nor a capture and eager
    launches: a capture's pair comes from its graph's memory pool (the
    counters' zeroing one node of the graph), so no later call can grow
    and free memory a graph points into; it is dropped, and left to the
    graph, when the stream next launches outside that capture.  The caller
    keeps the pair alive until the kernel is launched."""
    key = (device.index, stream)
    held = _SCRATCH.get(key)
    if (held is None or held[0] != capture or held[1].numel() < n_partials
            or held[2].numel() < n_counters):
        had = ((0, 0) if held is None or held[0] != capture
               else (held[1].numel(), held[2].numel()))
        held = _SCRATCH[key] = (
            capture,
            torch.empty(max(n_partials, 2 * had[0]), dtype=torch.float32,
                        device=device),
            torch.zeros(max(n_counters, 2 * had[1]), dtype=torch.int32,
                        device=device))
    return held[1], held[2]


def _check(q, k, v, kv_len, block_kv) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.device != q.device:
            raise ValueError(f"kv_len is on {kv_len.device}, q on "
                             f"{q.device}")
        if kv_len.dtype != torch.int32 or kv_len.numel() != 1:
            raise TypeError("a kv_len tensor must hold one int32")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and k, v (B, S, KV, D); got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, D = q.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError("k and v differ in shape")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported; bf16 or f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if H % k.shape[2]:
        raise ValueError(f"H={H} not a multiple of KV={k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if block_kv < 1:
        raise ValueError(f"block_kv={block_kv} must be >= 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_decode_cuda(
    q: torch.Tensor,                     # (B, H, D): one token per row
    k: torch.Tensor,                     # (B, S, KV, D) cache buffer
    v: torch.Tensor,                     # (B, S, KV, D)
    kv_len: Union[int, torch.Tensor],    # valid cache entries, all rows
    *,
    block_kv: int = 0,
) -> torch.Tensor:
    """Decode attention over the first ``kv_len`` cache entries,
    (B, H, D) in q's dtype; zeros where ``kv_len`` is 0.

    ``block_kv`` is the cache entries a block owns (clamped to S); 0 lets
    the launcher cut the cache to fill the card (``auto_block_kv``).  CUDA
    tensors launch the kernel (or raise); CPU tensors run
    ``decode_attention_ref``.  Nothing falls back from one to the other.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if block_kv == 0 and KV > 0 and H % KV == 0:  # else _check raises
        block_kv = auto_block_kv(B, S, H, KV, D, q.element_size(),
                                 _sm_count(q.device.index or 0))
    block_kv = min(block_kv, S)
    _check(q, k, v, kv_len, block_kv)
    rows = B * H * -(-S // block_kv)  # partial states: a row a split
    out = torch.empty_like(q)
    if isinstance(kv_len, torch.Tensor):
        len_ptr, len_value = kv_len.data_ptr(), 0
    else:
        len_ptr, len_value = None, int(kv_len)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    partials, counters = _scratch(
        q.device, stream, lib.repro_decode_capture(stream), rows * (D + 2),
        B * KV * -(-(H // KV) // head_tile(H, KV)))
    part = partials.data_ptr()
    err = lib.repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, len_value, part,
        part + 4 * rows, part + 8 * rows, counters.data_ptr(),
        out.data_ptr(), B, S, H, KV, D, build.DTYPE_CODE[q.dtype], block_kv,
        stream)
    if err:
        raise RuntimeError(
            f"flash decode kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} (B={B} S={S} "
            f"H={H} KV={KV} D={D} block_kv={block_kv})")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0


def decode_attention_ref(q, k, v, kv_len):
    """Plain PyTorch version: masked f32 attention of each row's query
    over the first ``kv_len`` cache entries (the reference's
    ``attention_ref`` over ``k[:, :kv_len]``).  At ``kv_len == 0`` every
    score is masked and the softmax is uniform: the mean of V, where the
    kernel writes zeros (ROADMAP queue 3)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float() / math.sqrt(D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    kv_len = torch.as_tensor(kv_len, device=q.device)
    valid = torch.arange(S, device=q.device) < kv_len
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(B, H, D).to(q.dtype)
