"""Flash-decode attention over a dense KV cache: the hand-written CUDA
kernel, its wrapper and its plain PyTorch version.

Counterpart of ``repro.kernels.decode_attention``: one query token per
sequence against a (B, S, KV, D) cache of which the first ``kv_len``
entries (one scalar for the batch) are valid.  The CUDA kernel
(``csrc/decode_attention.cu``, which documents its design and bound)
splits the cache axis into blocks of ``block_kv`` entries and merges the
splits in a second pass.  ``kv_len`` may be a Python int or a 0-d int32
device tensor; the kernel reads the tensor on the device, so the host
never waits for it.

``flash_decode_cuda`` launches the kernel for CUDA tensors and runs
``decode_attention_ref`` for CPU tensors; it counts its launches (one per
call, the split and the merge kernel together) in
``flash_decode_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Union

import torch

from repro_torch.kernels import build
# the split kernel's shared memory has the paged decode kernel's layout
# (per-warp and merged softmax state, csrc/common.cuh's head tiles); the
# library reports the compiled figure (repro_flash_decode_smem_bytes)
from repro_torch.kernels.paged_attention import smem_bytes

__all__ = ["flash_decode_cuda", "decode_attention_ref", "smem_bytes",
           "HEAD_DIMS", "NUM_WARPS"]

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
NUM_WARPS = (1, 2, 4, 8, 16, 32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("decode_attention")
    fn = lib.repro_flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_flash_decode_smem_bytes.restype = ctypes.c_int
    return lib


def _check(q, k, v, kv_len, block_kv, num_warps) -> None:
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
    if num_warps is not None and num_warps not in NUM_WARPS:
        raise ValueError(f"num_warps={num_warps} not in {NUM_WARPS}")
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
    block_kv: int = 256,
    num_warps: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over the first ``kv_len`` cache entries,
    (B, H, D) in q's dtype; zeros where ``kv_len`` is 0.

    ``block_kv`` is the cache entries a block owns (clamped to S);
    ``num_warps`` sets the split kernel's block size, None (or 0) lets the
    launcher take the most warps its registers allow, at least 8 entries
    a warp.  CUDA tensors launch the kernel (or raise); CPU tensors run
    ``decode_attention_ref``.  Nothing falls back from one to the other.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    num_warps = num_warps or None
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    block_kv = min(block_kv, S)
    _check(q, k, v, kv_len, block_kv, num_warps)
    n_split = -(-S // block_kv)
    out = torch.empty_like(q)
    part_ml = torch.empty((2, B, H, n_split), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, H, n_split, D), dtype=torch.float32,
                           device=q.device)
    if isinstance(kv_len, torch.Tensor):
        len_ptr, len_value = kv_len.data_ptr(), 0
    else:
        len_ptr, len_value = None, int(kv_len)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, len_value,
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, S, H, KV, D, build.DTYPE_CODE[q.dtype], block_kv,
        num_warps or 0, stream)
    if err:
        raise RuntimeError(
            f"flash decode kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} (B={B} S={S} "
            f"H={H} KV={KV} D={D} block_kv={block_kv} "
            f"num_warps={num_warps or 'auto'})")
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
