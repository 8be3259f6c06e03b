"""Fused RMSNorm: the hand-written CUDA kernel, its wrapper and its plain
PyTorch version.

Counterpart of ``repro.kernels.rmsnorm``.  The CUDA kernels
(``csrc/rmsnorm.cu``, which documents their design and bound) normalize
each row of an (..., d) tensor in one warp: f32 statistics, output cast
back to x's dtype.  Where d is a multiple of a 16-byte vector and the
tensors are 16-byte aligned (every model shape, up to 8192 bf16 or 4096
f32 elements a row), the row stays in the warp's registers between its
one read and its write; any other row takes the loop kernel, which reads
it twice.

``rmsnorm_cuda`` launches the kernel for CUDA tensors and runs
``ref.rmsnorm_ref`` for CPU tensors; it counts its kernel launches in
``rmsnorm_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_ref

__all__ = ["rmsnorm_cuda", "smem_bytes", "NUM_WARPS"]

NUM_WARPS = (1, 2, 4, 8, 16, 32)


def smem_bytes() -> int:
    """Shared memory of one block: none (a row lives in one warp's
    registers, the scale is read through L1).  The library reports the compiled kernel's own figure
    (``repro_rmsnorm_smem_bytes``); ``chip_smoke.py`` holds the two
    equal."""
    return 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("rmsnorm")
    fn = lib.repro_rmsnorm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_rmsnorm_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_rmsnorm_smem_bytes.restype = ctypes.c_int
    return lib


def _check(x, scale, block_rows, num_warps) -> None:
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x.dtype not in build.DTYPE_CODE:
        raise TypeError(f"dtype {x.dtype} not supported; bf16 or f32")
    if scale.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"scale must be float32 or x's dtype {x.dtype}; "
                        f"got {scale.dtype}")
    if x.dim() < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"scale {tuple(scale.shape)} must be (d,) for x "
                         f"{tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("x is empty")
    if block_rows < 1:
        raise ValueError(f"block_rows={block_rows} must be >= 1")
    if num_warps is not None and num_warps not in NUM_WARPS:
        raise ValueError(f"num_warps={num_warps} not in {NUM_WARPS}")
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rmsnorm_cuda(
    x: torch.Tensor,      # (..., d)
    scale: torch.Tensor,  # (d,)
    *,
    eps: float = 1e-6,
    block_rows: int = 4,
    num_warps: Optional[int] = None,
) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in x's
    dtype, statistics in f32.

    ``block_rows`` is the rows a block owns; ``num_warps`` sets the CUDA
    block size (one row per warp at a time), at most the warps the
    kernel's registers allow; None (or 0) lets the launcher take that
    most, at most ``block_rows``.  CUDA tensors launch the kernel (or raise); CPU
    tensors run ``rmsnorm_ref``.  Nothing falls back from one to the
    other.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    num_warps = num_warps or None
    _check(x, scale, block_rows, num_warps)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    per = 16 // x.element_size()
    vec = (d % per == 0 and all(t.data_ptr() % 16 == 0
                                for t in (x, scale, out)))
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
        build.DTYPE_CODE[x.dtype], build.DTYPE_CODE[scale.dtype], int(vec),
        eps, block_rows, num_warps or 0, stream)
    if err:
        raise RuntimeError(
            f"rmsnorm kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} (rows={rows} "
            f"d={d} block_rows={block_rows} "
            f"num_warps={num_warps or 'auto'})")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
