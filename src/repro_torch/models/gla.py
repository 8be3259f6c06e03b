"""Chunked gated linear attention (GLA): the recurrence core of Mamba2.

Counterpart of ``repro.models.gla``:

    S_t = exp(g_t) · S_{t-1} + k_t v_tᵀ          (state: dk × dv per head)
    y_t = q_tᵀ S_t

with per-step, per-head log-decay ``g_t ≤ 0``, evaluated chunkwise: within
a chunk the quadratic form with decay matrix ``exp(c_t − c_s)`` (c = the
inclusive cumsum of g), across chunks a loop carries the state.  This is
the plain PyTorch version: the model's ``gla_impl="jnp"`` path, and what
the CUDA kernel (``kernels/csrc/gla.cu``) is held to.  It stays
differentiable by autograd.

All math is f32; decays are exponentiated differences, masked before
``exp``, so nothing overflows.  The cumsum is f32 (``kernels.ref.
cumsum_f32``: left to right on the CPU, as the reference adds).  Padding steps get a zero gate and zero
q/k/v.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import cumsum_f32

__all__ = ["chunked_gla", "gla_step"]


def chunked_gla(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_g: torch.Tensor,  # (B, S, H) per-step log decay (≤ 0)
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, dk, dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, H, dv) in v's dtype, final_state: (B, H, dk, dv)
    f32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    # .float() keeps a broadcast (stride-0) q or k a view when it is f32
    qf, kf, vf, gf = q.float(), k.float(), v.float(), log_g.float()
    if pad:
        qf = F.pad(qf, (0, 0, 0, 0, 0, pad))
        kf = F.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = F.pad(vf, (0, 0, 0, 0, 0, pad))
        gf = F.pad(gf, (0, 0, 0, pad))
    nc = (S + pad) // L
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B, H, dk, dv), dtype=torch.float32,
                              device=q.device))
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    ys = []
    for i in range(nc):
        sl = slice(i * L, (i + 1) * L)
        qb, kb, vb, gb = qf[:, sl], kf[:, sl], vf[:, sl], gf[:, sl]
        c = cumsum_f32(gb, dim=1)  # inclusive (B, L, H)
        # inter-chunk: exp(c_t) · q_tᵀ S_in
        y_inter = torch.einsum("blhk,bhkv->blhv",
                               qb * torch.exp(c)[..., None], state)
        # intra-chunk: decay matrix exp(c_t − c_s), s ≤ t
        dmat = c[:, :, None, :] - c[:, None, :, :]  # (B, t, s, H)
        dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
        att = torch.einsum("blhk,bmhk->blmh", qb, kb) * torch.exp(dmat)
        y_intra = torch.einsum("blmh,bmhv->blhv", att, vb)
        # state out: S = exp(c_L) S_in + Σ_s exp(c_L − c_s) k_s v_sᵀ
        cL = c[:, -1, :]  # (B, H)
        k_decay = torch.exp(cL[:, None, :] - c)  # (B, L, H)
        state = (torch.exp(cL)[:, :, None, None] * state
                 + torch.einsum("blhk,blhv->bhkv", kb * k_decay[..., None],
                                vb))
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(v.dtype), state


def gla_step(
    q: torch.Tensor,  # (B, H, dk)
    k: torch.Tensor,  # (B, H, dk)
    v: torch.Tensor,  # (B, H, dv)
    log_g: torch.Tensor,  # (B, H)
    state: torch.Tensor,  # (B, H, dk, dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update (the decode path). O(dk·dv) a head."""
    decay = torch.exp(log_g.float())[..., None, None]
    state_new = decay * state.float() + torch.einsum(
        "bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", q.float(), state_new)
    return y.to(v.dtype), state_new
