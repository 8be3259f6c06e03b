"""Chunked gated linear attention (GLA): the hand-written CUDA kernel and
its wrapper.

Counterpart of ``repro.kernels.gla``.  The CUDA kernel (``csrc/gla.cu``,
which documents its design and bound) computes what ``gla_pallas``
computes: y (B, S, H, dv) in v's dtype and the final state (B, H, dk, dv)
in f32 from a zero initial state, all arithmetic in f32, chunks of
``chunk`` steps (clamped to S), padding steps masked.  It splits the
sequence across blocks in the chunk-parallel form (chunk states, a scan
over chunks, then outputs; three kernels, one launch a call as counted)
and runs its products on the tensor cores as 3xTF32.  Its plain PyTorch
version is ``models.gla.chunked_gla``; ``ref.gla_chunk_parallel_ref``
follows the kernel's algorithm on the CPU and ``ref.gla_ref`` is the
O(S²) oracle.

q, k and v may have any element strides whose last one is 1: Mamba2's q
and k are one (B, S, dk) row broadcast over the heads (head stride 0),
which the kernel reads as it is instead of materializing H copies, and
for which it computes q k^T once for two heads.

``gla_cuda`` launches the kernel for CUDA tensors and runs
``chunked_gla`` for CPU tensors; it counts its calls that launch in
``gla_cuda.launches``.  Like ``gla_pallas`` it has no gradient: a CUDA
call that autograd would have to differentiate raises (the plain version
stays differentiable).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

__all__ = ["gla_cuda", "smem_bytes", "MAX_DIM", "MAX_CHUNK", "TILE"]

MAX_DIM = 128     # dk and dv: the f32 state of a head in a block's tiles
MAX_CHUNK = 1024  # the in-block scan's reach
TILE = 64         # query rows, key rows and dv columns of a block's tile


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stride4(x: int) -> int:  # the smallest row stride >= x that is 4 mod 32
    return (x + 27) // 32 * 32 + 4


def _stride8(x: int) -> int:  # the smallest row stride >= x that is 8 mod 32
    return (x + 23) // 32 * 32 + 8


def smem_bytes(dk: int, dv: int, chunk: int) -> int:
    """Dynamic shared memory of the largest block a call launches at chunk
    length ``chunk`` (already clamped to S; the kernels have no static
    shared memory), in f32 words: the chunk-state kernel's cumsum (the
    chunk rounded up to whole tiles), decayed-k and v tiles; the output
    kernel's, at a head group of two, two cumsums, the q and k tiles and
    two v tiles (or one head's S_c), rows padded so fragment loads miss
    bank conflicts.  ``csrc/gla.cu::repro_gla_smem_bytes`` is the same
    formula; ``chip_smoke.py`` holds the two equal."""
    del dv  # dv runs in tiles of TILE columns
    Lp = _round_up(chunk, TILE)
    dkp = _round_up(dk, 8)
    state = (Lp + TILE * _stride8(_round_up(dk, 16))
             + TILE * _stride8(TILE))
    out = (2 * Lp + 2 * TILE * _stride4(dkp)
           + max(2 * TILE * _stride4(TILE),
                 _round_up(dkp, TILE) * _stride8(TILE)))
    return 4 * max(state, out)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("gla")
    fn = lib.repro_gla
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_gla_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_gla_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(q, k, v, log_g, chunk) -> None:
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
            f"dk={dk}, dv={dv}: the GLA kernel keeps a head's (dk x dv) f32 "
            f"state in one block's tiles and takes dk, dv <= {MAX_DIM}; a "
            f"larger head (xLSTM's mLSTM, dk=512) needs a state split "
            f"across blocks, which is not ported")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} not in [1, {MAX_CHUNK}]")
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported; bf16 or f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not log_g.is_floating_point():
        raise TypeError(f"log_g must be floating point; got {log_g.dtype}")


def head_group(q: torch.Tensor, k: torch.Tensor) -> int:
    """Heads an output block takes: two when q and k are one row broadcast
    over an even number of heads (both head strides 0), so the block
    computes q k^T once for both; else one."""
    H = q.shape[2]
    return 2 if H % 2 == 0 and H > 1 and q.stride(2) == 0 \
        and k.stride(2) == 0 else 1


def gla_cuda(
    q: torch.Tensor,      # (B, S, H, dk)
    k: torch.Tensor,      # (B, S, H, dk)
    v: torch.Tensor,      # (B, S, H, dv)
    log_g: torch.Tensor,  # (B, S, H), <= 0
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, dv) in v's dtype, final state (B, H, dk, dv) f32),
    from a zero initial state.

    ``chunk`` is the chunk length (clamped to S).  CUDA tensors launch the
    kernel (or raise); CPU tensors run ``chunked_gla``.  Nothing falls
    back from one to the other.
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
    _check(q, k, v, log_g, chunk)
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    g = log_g.float().contiguous()
    L = min(chunk, S)
    n_chunks = -(-S // L)
    y = torch.empty((B, S, H, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    chunk_state = torch.empty((B, H, n_chunks, dk, dv), dtype=torch.float32,
                              device=q.device)
    decay = torch.empty((B, H, n_chunks), dtype=torch.float32,
                        device=q.device)
    hg = head_group(q, k)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_gla(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        y.data_ptr(), state.data_ptr(), chunk_state.data_ptr(),
        decay.data_ptr(), B, S, H, dk, dv, build.DTYPE_CODE[v.dtype], L,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], hg, stream)
    if err:
        raise RuntimeError(
            f"GLA kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} (B={B} S={S} "
            f"H={H} dk={dk} dv={dv} chunk={L} head group {hg})")
    gla_cuda.launches += 1
    return y, state


gla_cuda.launches = 0
