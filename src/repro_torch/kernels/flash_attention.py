"""Flash attention: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention``.  The CUDA kernel
(``csrc/flash_attention.cu``, which documents its design and bound) keeps
the reference kernel's tile geometry: ``block_q`` and ``block_kv`` are
clamped to Sq and Sk, tiles wholly above the causal diagonal or left of
the window are skipped, and masked scores are -1e30.

``flash_attention_cuda`` launches the kernel for CUDA tensors and runs
``ref.attention_ref`` for CPU tensors; it counts its kernel launches in
``flash_attention_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

__all__ = ["flash_attention_cuda", "smem_bytes", "HEAD_DIMS", "NUM_WARPS",
           "MAX_BLOCK_KV"]

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
NUM_WARPS = (1, 2, 4, 8, 16)
MAX_BLOCK_KV = 128  # each lane scores at most 4 keys of a tile
_DTYPE_SIZE = {"float32": 4, "bfloat16": 2}


def smem_bytes(head_dim: int, dtype: str, block_q: int, block_kv: int
               ) -> int:
    """Dynamic shared memory of one block (the kernel has no static
    shared memory): the f32 query tile and accumulator, the f32 row state
    m and l, and the K and V tiles in the input dtype, rows padded by 4
    bytes.  ``csrc/flash_attention.cu::smem_bytes`` is the same formula;
    ``chip_smoke.py`` holds the two equal."""
    size = _DTYPE_SIZE[dtype]
    stride = head_dim + 4 // size
    return ((2 * block_q * head_dim + 2 * block_q) * 4
            + 2 * block_kv * stride * size)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_flash_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(q, k, v, block_q, block_kv, num_warps) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KV, D);"
                         f" got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, D = q.shape
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
    if not 1 <= block_kv <= MAX_BLOCK_KV or block_q < 1:
        raise ValueError(f"block_q={block_q} must be >= 1 and block_kv="
                         f"{block_kv} in [1, {MAX_BLOCK_KV}]")
    if num_warps is not None and num_warps not in NUM_WARPS:
        raise ValueError(f"num_warps={num_warps} not in {NUM_WARPS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    block_q: int = 64,
    block_kv: int = 32,
    num_warps: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention, (B, Sq, H, D) in q's dtype.

    ``block_q`` and ``block_kv`` are the reference's tile sizes (clamped to
    Sq and Sk); ``num_warps`` sets the CUDA block size, None (or 0) lets
    the launcher take the most warps its registers allow, at most the
    tile's rows.  CUDA tensors launch the kernel (or raise); CPU tensors
    run ``attention_ref``.  Nothing falls back from one to the other.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    num_warps = num_warps or None
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    block_q, block_kv = min(block_q, Sq), min(block_kv, Sk)
    _check(q, k, v, block_q, block_kv, num_warps)
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, D, build.DTYPE_CODE[q.dtype], int(causal), int(window),
        int(q_offset), block_q, block_kv, num_warps or 0, stream)
    if err:
        raise RuntimeError(
            f"flash attention kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} (B={B} Sq={Sq} "
            f"Sk={Sk} H={H} KV={KV} D={D} block_q={block_q} "
            f"block_kv={block_kv} num_warps={num_warps or 'auto'})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
