"""Plain PyTorch oracles for the ported kernels (the allclose references).

Counterpart of ``repro.kernels.ref``: ``attention_ref`` (the plain
version of the flash attention kernel, and the dense attention the decode
kernels are checked against) and ``rmsnorm_ref``.  ``gla_ref`` comes with
its kernel (ROADMAP queue 2).
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "rmsnorm_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialized-logits GQA attention, f32 softmax."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float() / math.sqrt(D)
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, vf)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Mean of squares in f32, ``x * rsqrt(var + eps) * scale``, cast
    back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
