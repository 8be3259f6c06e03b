"""Chunked gated linear attention (GLA): the hand-written CUDA kernel and
its wrapper.

Counterpart of ``repro.kernels.gla``.  The CUDA kernel (``csrc/gla.cu``,
which documents its design and bound) computes what ``gla_pallas``
computes: y (B, S, H, dv) in v's dtype and the final state (B, H, dk, dv)
in f32 from a zero initial state, all arithmetic in f32, chunks of
``chunk`` steps (clamped to S), padding steps masked.  Its plain PyTorch
version is ``models.gla.chunked_gla``; ``ref.gla_ref`` is the O(S²)
oracle.

q, k and v may have any element strides whose last one is 1: Mamba2's q
and k are one (B, S, dk) row broadcast over the heads (head stride 0),
which the kernel reads as it is instead of materializing H copies.

``gla_cuda`` launches the kernel for CUDA tensors and runs
``chunked_gla`` for CPU tensors; it counts its kernel launches in
``gla_cuda.launches``.  Like ``gla_pallas`` it has no gradient: a CUDA
call that autograd would have to differentiate raises (the plain version
stays differentiable).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["gla_cuda", "smem_bytes", "MAX_DIM", "MAX_CHUNK", "NUM_WARPS",
           "SUB_TILE"]

MAX_DIM = 128     # dk and dv: the f32 state must fit one block
MAX_CHUNK = 1024  # the in-block scan's reach
NUM_WARPS = (1, 2, 4, 8, 16)
SUB_TILE = 64     # query and key sub-tile rows of a chunk


def smem_bytes(dk: int, dv: int, chunk: int) -> int:
    """Dynamic shared memory of one block at chunk length ``chunk``
    (already clamped to S; the kernel has no static shared memory), in f32
    words: the (dk x dv) state, the chunk's cumsum, the q, k (rows padded
    by one word) and v sub-tiles of min(64, chunk) rows, their score tile
    and the output accumulator.  ``csrc/gla.cu::smem_words`` is the same
    formula; ``chip_smoke.py`` holds the two equal."""
    ts = min(SUB_TILE, chunk)
    return 4 * (dk * dv + chunk + ts * dk + ts * (dk + 1) + ts * dv
                + ts * ts + ts * dv)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("gla")
    fn = lib.repro_gla
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_gla_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_gla_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(q, k, v, log_g, chunk, num_warps) -> None:
    for name, t in (("k", k), ("v", v), ("log_g", log_g)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k must be (B, S, H, dk) and v (B, S, H, dv); "
                         f"got {tuple(q.shape)} and {tuple(v.shape)}")
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if tuple(log_g.shape) != (B, S, H):
        raise ValueError(f"log_g {tuple(log_g.shape)} must be (B, S, H) = "
                         f"{(B, S, H)}")
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(
            f"dk={dk}, dv={dv}: the GLA kernel keeps the (dk x dv) f32 "
            f"state in one block's shared memory and takes dk, dv <= "
            f"{MAX_DIM}; a larger head (xLSTM's mLSTM, dk=512) needs a "
            f"state split across blocks, which is not ported")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} not in [1, {MAX_CHUNK}]")
    if num_warps is not None and num_warps not in NUM_WARPS:
        raise ValueError(f"num_warps={num_warps} not in {NUM_WARPS}")
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported; bf16 or f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not log_g.is_floating_point():
        raise TypeError(f"log_g must be floating point; got {log_g.dtype}")


def gla_cuda(
    q: torch.Tensor,      # (B, S, H, dk)
    k: torch.Tensor,      # (B, S, H, dk)
    v: torch.Tensor,      # (B, S, H, dv)
    log_g: torch.Tensor,  # (B, S, H), <= 0
    *,
    chunk: int = 128,
    num_warps: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, dv) in v's dtype, final state (B, H, dk, dv) f32),
    from a zero initial state.

    ``chunk`` is the chunk length (clamped to S); ``num_warps`` sets the
    CUDA block size, None (or 0) lets the launcher take the most warps its
    registers allow.  CUDA tensors launch the kernel (or raise); CPU
    tensors run ``chunked_gla``.  Nothing falls back from one to the
    other.
    """
    if q.device.type == "cpu":
        # imported here: models/ imports the kernel entry points
        from repro_torch.models.gla import chunked_gla

        return chunked_gla(q, k, v, log_g, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, log_g)):
        raise RuntimeError(
            "the CUDA GLA kernel has no gradient, as the reference's "
            "gla_pallas has none (jax.grad cannot differentiate it either); "
            "call it under torch.no_grad() or use gla_impl='jnp' "
            "(models.gla.chunked_gla) to differentiate")
    num_warps = num_warps or None
    _check(q, k, v, log_g, chunk, num_warps)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    g = log_g.float().contiguous()
    L = min(chunk, S)
    y = torch.empty((B, S, H, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_gla(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, S, H, dk, dv,
        build.DTYPE_CODE[v.dtype], L, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], num_warps or 0, stream)
    if err:
        raise RuntimeError(
            f"GLA kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} (B={B} S={S} "
            f"H={H} dk={dk} dv={dv} chunk={L} "
            f"num_warps={num_warps or 'auto'})")
    gla_cuda.launches += 1
    return y, state


gla_cuda.launches = 0
